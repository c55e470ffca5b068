#!/usr/bin/env python3
"""On-card smoke test of namazu_tpu_torch, the PyTorch/CUDA port of the
search plane. Needs one CUDA card (an H100 for the sm_90a kernels) and
nvcc; run from the repository root:

    python3 chip_smoke.py                 # every phase
    python3 chip_smoke.py --kernels-only  # phases 1-2, untimed

Phases, each of which fails the script on any error:

1. card: the card's name and power limit, torch and CUDA versions, and
   the build of every kernel under namazu_tpu_torch/csrc/ (nvcc output
   with ptxas's register report included), with the count of tensor-core
   products (HGMMA) and TMA loads (UTMALDG) in each library's SASS; none
   of either fails the phase;
2. kernels: each kernel (B1 the pair distance, B2 the single-archive
   distance) against its plain PyTorch version on the card, in f32 and in
   f64, at the main path's shape, at ragged shapes, widths and
   occupancies, on near-binary rows with exact and near duplicates (held
   to the f64 plain version alone: where d2 cancels to 0 the f32 one's
   own rounding exceeds atol) and on the main path's own feature rows;
   then its time (warm and
   with a cold L2), the plain version's, a library call's, and the bound
   the split-TF32 tensor-core arithmetic sets;
3. fused search: ScheduleSearch on the card at the tpu_search policy's
   sizes (population 4096, H = K = 256, archive 512, failures 64, chunks
   of 16 generations, surrogate off) against 4 reference traces of 2000
   events, run twice for 64 generations; B1 must launch once per
   generation, and the best table re-scored on the CPU by the plain
   versions must give the reported fitness;
4. where a generation's time goes: each layer timed alone, and one chunk
   of generations traced by torch.profiler for the device's busy share;
5. sidecar path: a naive storage of 48 recorded runs of 2000 actions
   (8 of them failures) written to disk, the port's sidecar serving on
   the card in a thread, and two search requests over one keep-alive
   connection carrying the tpu_search policy's default params (surrogate
   top-16 included), 64 generations each: history ingest, GA search,
   surrogate re-rank and checkpoint. B1 must launch 2 * 64 + 2 times
   (once per generation, once per re-rank), the surrogate must train,
   the checkpoint must hold the reference's keys, and the returned table
   re-scored on the CPU must give the returned fitness;
6. fault path: a second storage of 48 runs of 2000 actions (8 failures)
   whose every fourth flow records as ProcSetEvent (a class that carries
   no fault), and two requests at the policy's defaults with
   ``max_fault = 0.1``: B1 launches 2 * 64 + 2 times, the returned fault
   table lies in [0, 0.1] and is not all zero, the table and its faults
   re-scored on the CPU with the coin give the returned fitness; a
   generation's layers are timed alone and traced, as in phase 4;
7. order path: the same storage with ``release_mode = "reorder"``
   (reorder window 0.05 s, gap 0.002 s; ingest caps traces at 4096
   events): the same checks and timings as phase 6, and the order-mode
   feature step timed alone at [4096, 4, 2048] and [4096, 4, 4096] with
   its peak device memory;
8. MCTS path: the same storage with ``search_backend = "mcts"`` at the
   policy's MCTS defaults (256 simulations, depth 24, 8 levels, 64
   rollouts), one search a request: B1 launches 2 * 256 times, the
   checkpoint says ``backend = "mcts"``, the returned table re-scored on
   the CPU gives the returned fitness; simulations/s and rollouts/s,
   and one search traced for the device's busy share;
9. islands (BASELINE config 4's layout): a search built from the
   policy's defaults with ``max_fault = 0.1`` over 8 islands of 512 on
   the card (ring of 8 every generation), fed phase 6's history, run
   twice for 64 generations: B1 launches once a shard and generation and
   once a re-rank (2 * 64 + 2), the returned table re-scored on the CPU
   gives the returned fitness; a marker planted on island 0 rides the
   ring into island 1's tail rows and not its elites; fused == stepwise
   over 5 generations; 2 shards of 4 == 1 shard of 8 after 16
   generations, bit for bit; then the same islands in delay mode on
   phase 5's history; schedules/s, the GA's and one migration's ms, and
   one 16-generation chunk traced (device ms, busy share, launches and
   RNG launches a generation);
10. the 2 x 4 hybrid mesh on the card (host ring of 2 every 4th
   generation) in delay mode, the same checks and timings as phase 9,
   and the host ring landing only on generations divisible by 4; 8
   root-parallel MCTS trees in lockstep at the policy's MCTS defaults
   (B1 launches once a simulation for all 8 trees, one sync a
   simulation, the table re-scored on the CPU); a one-process NCCL world
   started by ``initialize_from_env`` in which the hybrid search goes
   through the collectives and equals the same mesh without them, bit
   for bit;
11. knowledge and guidance path: the port's sidecar hosting its
   knowledge service over a pool directory, and two campaigns of one
   scenario whose requests carry every knob (guidance in search and
   ingest, a failure pool of their own, the knowledge service at the
   sidecar's own address), two requests each at the policy's sizes
   (64 generations, the surrogate re-ranking the top 16; guidance
   bitmap 4096 bits, window 16, surrogate [K | 20] wide). Campaign A
   evolves on phase 5's history and its requests carry
   ``device_trace_dir``: request 1 writes one trace, request 2 none.
   Campaign B is a cold storage of 48 runs that all fail but one, so
   its own surrogate is too thin to train and its re-ranks ask the
   service's, which must answer trained. B1 launches 2 * 64 + 2 times a
   campaign; B's first ingest folds A's signatures and coverage bits;
   the mutation bias exceeds 1; the checkpoint holds the reference's
   keys and ``guidance_feats`` [512, 20]; ``stats`` shows both tenants;
   every returned table re-scored on the CPU gives the returned fitness;
12. in-process policy path: what a ``torch_search`` campaign runs between
   two runs, the policy's search half (``namazu_tpu_torch.policy.tpu``)
   at the policy's defaults over phase 5's history, on its own thread as
   ``_search_once`` runs it, twice: the checkpoint's best installed
   first, the search built and resumed from the checkpoint, ingest, 64
   generations, re-rank, save. B1 launches 2 * 64 + 2 times; the second
   search installs the first's checkpointed best before its own; the
   checkpoint holds the reference's keys; the returned table re-scored on
   the CPU gives the returned fitness; a recording sink sees the
   phases and calls the reference's search makes (the policy's own
   ``ingest`` and ``install`` phases are the reference's, which this
   script does not import; it reads the history with the port's reader,
   not through the policy's storage adapter, which
   ``tests/test_torch_cuda.py`` times at this width); the first search's
   ``device_trace_dir``
   capture, taken on that thread, holds the island step's ranges
   ``nmz_score``, ``nmz_mutate``, ``nmz_select`` with CUDA kernels inside
   (``nmz_migrate`` too, empty on one island, and with kernels in one
   traced chunk of 8 islands built by the policy's build); ``dcn_hosts =
   2`` on one card is refused with the reference's message inside a
   one-process NCCL world started from the environment;
13. observed sidecar: ``namazu_tpu_torch_sidecar.py`` (the port's
   ``nmz-tpu sidecar``, which imports the reference's observability
   plane; this script imports neither it nor the reference) started as a
   child process on the card with a knowledge pool and
   ``--telemetry-url`` at a framed push target hosted here, read only
   over its wire: phase 5's request twice on one keep-alive connection
   over phase 5's history (both carry ``device_trace_dir``; the capture
   is one-shot), then a knowledge ``stats`` op. Every answer is ok,
   ``generations_run`` is 64 then 128, the returned table re-scored on
   the CPU from the child's checkpoint gives the returned fitness; the
   child's capture of request 0 holds B1 inside each of the 64
   ``nmz_score`` ranges; the ``metrics`` op counts 2 search requests, 1
   ``stats``, 128 GA generations, the search's phases and a scorer
   rate; the ``fleet`` op lists job ``sidecar``; the ``profile`` op has
   samples and stacks under ``ingest_history`` (their share and the top
   self-time frames are printed); the push target receives a doc of job
   ``sidecar`` counting both searches within 3 relay intervals. The
   requests' walls and seconds by phase print beside phase 5's of the
   same call; then the package's own sidecar (no sink, relay or
   profiler) starts as a second child, and warm requests go to the two
   in turns for the plane's cost. The children are terminated in any
   case, their logs printed when a check fails;
14. chaos over the campaign's memory: phase 11's campaign A (two
   requests at the policy's defaults over phase 5's history, every knob
   on, the knowledge service hosted by the sidecar itself, over a fresh
   pool) with a fault schedule installed in the package's chaos seams
   (``namazu_tpu_torch/chaos.py``): ``knowledge.eof`` on two first
   attempts, ``storage.tear`` and ``storage.fsync`` on the service's
   first two state writes, ``knowledge.outage`` on request 2's first
   knowledge op; after each request its table is pushed as the policy's
   best. Every request answers ok and re-scores on the CPU to its
   fitness, B1 launches 2 * 64 + 2 times, every point fires, the
   client's counts agree with the fire log (each eof retried, one
   outage and its cooldown); cleared and restarted on the same port and
   pool, the service answers a pull with the highest acknowledged
   fitness; the pool fscks clean and the state directory holds the
   torn temp. Its walls print beside phase 11's campaign A;
15. driver entry (``namazu_tpu_torch/entry.py``, the counterpart of
   ``__graft_entry__.py``): ``entry()``'s scorer once on the card (B1
   once), within rtol 1e-3 / atol 1e-4 of the same fn on the CPU's
   plain versions on the same inputs; ``dryrun_multichip(8)`` (8
   islands, then the 2 x 4 hybrid mesh, on the card) and
   ``dryrun_multichip_fused(16)`` (a 4 x 4 topology mesh against one
   island, 4 dispatches of 8 generations each), B1 once a shard and
   generation, the overhead factor printed;
16. the port's bench (``namazu_tpu_torch/bench.py``, the counterpart of
   ``bench.py``'s scorer and fused benches) in this process at
   ``bench.py``'s sizes (P = 8192, H = L = K = 256, archive 1024, 64
   failures, 50 passes or generations, best of 5): each returns
   platform ``cuda``, the card's name and power limit and a positive
   rate, and publishes its record into a temporary history; the
   scorer's accuracy check (64 genomes against the CPU's plain
   versions) passes; B1 launches 1 + 6 * 50 times for the scorer and
   6 * 50 + 1 + 5 * 50 for the fused bench; one scoring chain read back
   makes one sync (the read); device ms and launches a pass and a
   generation are printed.

Phase 2 also holds B1 at the rollout shapes N = 256 and N = 64 (A = 512,
F = 64, K = 256), at phase 10's 8 lockstep trees' N = 2048 and at the
bench's shape (N = 8192, A = 1024, F = 64, K = 256), where the grid plan splits the column walk over a cluster, with
occupancies that mask whole ranks and int32 occupancies read on the card,
and times it there; it prints each timed shape's plan (row tiles, split,
blocks, rows a block, steps a block), holds rows [:64] of a main-shape
input alone (a split grid) to the same rows inside the full launch (no
split) bit for bit, times the MCTS shapes (and phase 10's 8 trees, N =
2048) under the other block height too and holds its rows bit for bit
to the plan's, and counts the CUDA kernels of one B1 call at each timed
shape under torch.profiler (must be 1). Several cards and several processes
are not driven here (one card): the islands and trees of phases 9-10
share the card. Phases 11-12 print each request's or search's wall and
ingest. The last lines are the card line, a JSON line with every
kernel's numbers (launches on every path; phase 13's are the kernels in
the child's capture), and ``{"ok": true, "device":
{...}}``.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import socket
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

RTOL, ATOL = 1e-3, 1e-4
# published H100 SXM peaks: HBM bandwidth, TF32 on the tensor cores (dense)
# and non-tensor f32
PEAK_BYTES_PER_S = 3.35e12
PEAK_TF32_FLOP_PER_S = 495e12
PEAK_F32_FLOP_PER_S = 67e12
# B1 and B2 take the cross term as three TF32 products (hi.hi' + hi.lo' +
# lo.hi'), so the tensor cores do three times the f32 product's work
TF32_SPLIT_PRODUCTS = 3
L2_FLUSH_BYTES = 128 << 20  # written before each cold-L2 launch (L2: 50 MB)
MAIN_SHAPE = (16384, 512, 64, 256)  # N = P*T, A, F, K on the main path
# B1 in an MCTS rollout: N = rollouts * traces (64 * 4), and 64 rows with
# one envelope reference trace
ROLLOUT_SHAPES = ((256, 512, 64, 256), (64, 512, 64, 256))
# B1 in the port's bench (namazu_tpu_torch/bench.py): P, A, F, K
BENCH_SHAPE = (8192, 1024, 64, 256)
# B1 in phase 10's 8 lockstep MCTS trees: 8 trees x 64 rollouts x 4 traces
TREES_SHAPE = (2048, 512, 64, 256)
SINGLE_SHAPE = (16384, 512, 256)  # B2 held at N, A, K
POPULATION, H, K, TRACES, EVENTS, GENERATIONS = 4096, 256, 256, 4, 2000, 64
HISTORY_RUNS, HISTORY_FAILURES = 48, 8

# TPUSearchPolicy()._search_params() and ._ingest_params()._asdict() at
# the policy's defaults (namazu_tpu/policy/tpu.py), as its sidecar
# requests carry them; tests/test_torch_sidecar.py holds them to the policy
POLICY_SEARCH_PARAMS = {
    "H": 256, "L": 0, "K": 256, "population": 4096, "migrate_k": 8,
    "fused": True, "fused_chunk": 16, "device_trace_dir": "",
    "migrate_every": 1, "dcn_migrate_every": 1, "seed": 0,
    "max_interval": 0.1, "max_fault": 0.0, "surrogate_topk": 16,
    "min_failure_signatures": 0, "novelty_floor": 0.25,
    "search_backend": "ga", "guidance": False, "guidance_bonus": 0.5,
    "guidance_width": 0, "guidance_window": 0, "mcts_tree_depth": 24,
    "mcts_levels": 8, "mcts_simulations": 256, "mcts_rollouts": 64,
    "release_mode": "delay", "w_novelty": 1.0, "w_bug": 1.0,
    "w_delay_cost": 0.01, "w_fault_cost": 0.05, "tau": 0.005,
    "reorder_gap": 0.002, "reorder_window": 0.05, "devices": None,
}
POLICY_INGEST_PARAMS = {
    "H": 256, "L": 0, "release_mode": "delay", "reference_mode": "recent",
    "max_interval": 0.1, "max_reference_traces": 4, "max_seed_genomes": 16,
    "order_mode_max_l": 4096, "failure_pool": "", "knowledge": "",
    "knowledge_tenant": "history", "knowledge_scenario": "",
    "guidance": False, "guidance_width": 0, "guidance_window": 0,
}
CHECKPOINT_KEYS = (
    "backend", "hint_space", "pairs", "archive", "archive_labels",
    "archive_n", "failures", "failure_n", "failure_digests", "key",
    "generations_run", "pop_delays", "pop_faults", "gen", "best_fitness",
    "best_delays", "best_faults", "surrogate_params")
MCTS_CHECKPOINT_KEYS = CHECKPOINT_KEYS[:11] + (
    "best_fitness", "best_delays", "best_faults")
# phases 6-8: what each path's requests add to the policy's defaults
EXTRA_PATHS = (
    ("sidecar_faults", {"max_fault": 0.1}, {}),
    ("sidecar_order", {"release_mode": "reorder"},
     {"release_mode": "reorder"}),
    ("sidecar_mcts", {"search_backend": "mcts"}, {}),
)


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


# -- phase 1: the kernels' machine code ------------------------------------


def cuobjdump() -> str:
    """The toolkit's cuobjdump, or the copy Triton ships."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "cuobjdump")):
            return os.path.join(root, "bin", "cuobjdump")
    found = shutil.which("cuobjdump")
    if found:
        return found
    import triton

    path = os.path.join(os.path.dirname(triton.__file__), "backends",
                        "nvidia", "bin", "cuobjdump")
    check(os.path.isfile(path), "no cuobjdump found")
    return path


def sass_counts(lib, ops=("HGMMA", "UTMALDG")) -> dict:
    """Per kernel function of the library ``lib``: how many of its SASS
    instructions are each of ``ops`` (the tensor-core product, the TMA
    tile load)."""
    out = subprocess.run([cuobjdump(), "-sass", str(lib)],
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout
    counts, fn = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = dict.fromkeys(ops, 0)
        elif fn is not None:
            for op in ops:
                if op in line:
                    counts[fn][op] += 1
    return counts


# -- phase 2: kernels against their plain versions --------------------------


SLEEP_CYCLES = 1 << 24  # ~8 ms of torch.cuda._sleep at the H100's clock


def queued(enqueue):
    """``enqueue()``'s result, its work queued on the card while the card
    sleeps, so that the card runs it back to back at its own pace and not
    at the host's (a call whose host side outlasts its kernel would
    otherwise time the host). Checks that the host finished queueing
    before the card woke; else retries with a four times longer sleep,
    and fails after three tries. Not every call gets ahead on an H100:
    ``torch.cdist`` waits for the card inside the call, and 50 calls of a
    plain version (some 20 launches each) did not either."""
    import torch

    cycles = SLEEP_CYCLES
    for _ in range(3):
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        woke = torch.cuda.Event()
        woke.record()
        out = enqueue()
        ahead = not woke.query()
        torch.cuda.synchronize()
        if ahead:
            return out
        cycles *= 4
    raise SmokeFailure("the host could not queue ahead of the card")


def device_time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean time of ``fn`` on the card: ``iters`` calls queued ahead of it
    (:func:`queued`), between two CUDA events."""
    import torch

    for _ in range(warmup):
        fn()

    def enqueue():
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        return start, stop

    start, stop = queued(enqueue)
    return start.elapsed_time(stop) / iters


def device_time_cold_ms(fn, iters: int = 20) -> float:
    """Mean time of ``fn`` on the card with a cold L2: a buffer larger than
    the L2 is written before each call, only the calls are timed, all of
    it queued ahead of the card."""
    import torch

    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device="cuda")
    fn()

    def enqueue():
        events = []
        for _ in range(iters):
            flush.fill_(1.0)
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            stop.record()
            events.append((start, stop))
        return events

    events = queued(enqueue)
    return sum(a.elapsed_time(b) for a, b in events) / iters


def pair_inputs(N, A, F, K, seed, device):
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    return tuple(torch.rand((n, K), generator=g, device=device)
                 for n in (N, A, F))


def near_binary_inputs(N, A, F, K, seed, device, exact_archive=True):
    """Feature rows near 0 or 1 (as the sigmoid precedence features are),
    with archive and failure rows copied from feature rows: exact copies
    in one segment (d2 = 0, the worst cancellation) and copies moved by
    +-1e-3 per coordinate in the other."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    feats = torch.sigmoid(8 * torch.randn((N, K), generator=g,
                                          device=device))

    def copies(n, jitter):
        idx = torch.randint(0, N, (n,), generator=g, device=device)
        rows = feats[idx].clone()
        if jitter:
            sign = 2 * torch.randint(0, 2, rows.shape, generator=g,
                                     device=device) - 1
            rows += jitter * sign
        return rows

    archive = copies(A, 0.0 if exact_archive else 1e-3)
    failures = copies(F, 1e-3 if exact_archive else 0.0)
    return feats, archive, failures


def bounds_ms(N, rows, K, outputs):
    """``(bound_ms, bound_by, bound_f32_simt_ms)`` of min distances from
    ``N`` feature rows to ``rows`` column rows of width ``K`` with
    ``outputs`` [N] results: bytes (each input read once, each output
    written once) at the HBM rate against the split-TF32 products on the
    tensor cores; the last is the same against f32 on the CUDA cores."""
    nbytes = 4 * (N * K + rows * K + outputs * N)
    flops = 2 * N * rows * K
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_tf32 = TF32_SPLIT_PRODUCTS * flops / PEAK_TF32_FLOP_PER_S * 1e3
    t_simt = max(t_bytes, flops / PEAK_F32_FLOP_PER_S * 1e3)
    return (max(t_bytes, t_tf32),
            "bytes" if t_bytes >= t_tf32 else "operations", t_simt)


def compare(name, got, want, where) -> float:
    """Max abs error of ``got`` against ``want`` over the rows that are not
    masked out; fails on a shape, a non-finite value, a masked-row
    mismatch or an error past rtol/atol."""
    import torch

    check(got.shape == want.shape and bool(torch.isfinite(got).all()),
          f"{name} at {where}: bad output")
    live = want < 1e30  # rows whose min is masked stay at 3.4e38
    check(bool(torch.equal(live, got < 1e30)),
          f"{name} at {where}: masked rows differ")
    ok = torch.allclose(got[live], want[live], rtol=RTOL, atol=ATOL)
    err = float((got[live] - want[live]).abs().max()) if live.any() \
        else 0.0
    check(ok, f"{name} at {where}: max abs err {err}")
    return err


def real_feature_rows(search, refs):
    """The main path's own B1 inputs: the population's feature rows
    (``_genome_features``, flattened to [P*T, K]) and the search's device
    archives, with its occupancies."""
    from namazu_tpu_torch.ops import schedule as sched

    traces, pairs, archive, failures = search._device_inputs(refs)
    feats, _ = sched._genome_features(search._state.pop.delays, traces,
                                      pairs, search.cfg.weights.tau)
    return (feats.reshape(-1, feats.shape[-1]).contiguous(), archive,
            failures, search._archive_n, search._failure_n)


def timing(kernel, plain, library, bound) -> dict:
    """The kernel's time on the card (calls queued ahead of it, warm and
    with a cold L2), and at the host's pace (``host_paced_ms``: launches
    timed as the host issues them, which at small shapes times the
    wrapper's host side, not the card); the plain version's and the
    library call's at the host's pace (see :func:`queued`)."""
    bound_ms, bound_by, simt_ms = bound
    return {
        "ms": device_time_ms(kernel),
        "ms_cold_l2": device_time_cold_ms(kernel),
        "host_paced_ms": cuda_time_ms(kernel),
        "plain_ms": cuda_time_ms(plain),
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "bound_ops": "tf32x3",
        "bound_f32_simt_ms": simt_ms,
        "library_ms": cuda_time_ms(library),
    }


def report(name, shape, numbers, max_err) -> None:
    print(f"  {name} at {shape}: kernel_ms {numbers['ms']:.5f} "
          f"cold_l2_ms {numbers['ms_cold_l2']:.5f} "
          f"host_paced_ms {numbers['host_paced_ms']:.5f} "
          f"plain_ms {numbers['plain_ms']:.5f} "
          f"library_ms {numbers['library_ms']:.5f} "
          f"bound_us {numbers['bound_ms'] * 1e3:.3f} "
          f"({numbers['bound_by']}, tf32x3; "
          f"{numbers['bound_ms'] / numbers['ms']:.1%} of it) "
          f"f32_simt_bound_us "
          f"{numbers['bound_f32_simt_ms'] * 1e3:.3f} "
          f"max_abs_err {max_err:.3e}")


def check_case(name, kernel, plain, tensors, occ, label, cancels) -> float:
    """One kernel case against its plain version on the same inputs, in
    f32 and in f64; returns the max abs error the case is held to. Every
    case must lie within rtol/atol of the f64 plain version. A case whose
    distances cancel to ~0 (duplicate rows) is held to that alone: there
    the f32 plain version's own error reaches ~1.5e-4 (see PERF.md), so
    atol 1e-4 against it would judge the plain version, not the kernel;
    its f32 error is printed beside. Every other case must also lie within
    rtol/atol of the f32 plain version."""
    import torch

    def as_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    got = as_tuple(kernel(*tensors, **occ))
    want32 = as_tuple(plain(*tensors, **occ))
    want64 = tuple(w.float() for w in as_tuple(
        plain(*(t.double() for t in tensors), **occ)))
    torch.cuda.synchronize()
    err = 0.0
    notes = []
    for i, (g, w32, w64) in enumerate(zip(got, want32, want64)):
        out = f"{name} output {i}"
        err64 = compare(out, g, w64, f"{label}, against f64")
        if cancels:
            live = w64 < 1e30
            plain_err = float((w32[live] - w64[live]).abs().max())
            notes.append(f"output {i}: kernel {err64:.3e} from f64, f32 "
                         f"plain {plain_err:.3e} from f64")
            err = max(err, err64)
        else:
            err = max(err, err64, compare(out, g, w32, label))
    print(f"  {name}, {label}: within rtol {RTOL} atol {ATOL} of the plain "
          f"version" + (" in f64; " + "; ".join(notes) if cancels else
                        " in f32 and in f64"))
    return err


def check_single_kernel(device, real=None, timed=True) -> dict:
    import torch

    from namazu_tpu_torch.ops import pair_distance as pd

    torch.backends.cuda.matmul.allow_tf32 = False
    cases = [(f"uniform {s} valid_n {vn}", pair_inputs(*s[:2], 1, s[2],
                                                        200 + i, device)[:2],
              vn, False)
             for i, (s, vn) in enumerate([
                 (SINGLE_SHAPE, None), (SINGLE_SHAPE, 300),
                 (SINGLE_SHAPE, 0), ((33, 7, 64), None), ((33, 7, 64), 3),
                 ((33, 7, 64), 0), ((300, 100, 128), 50),
                 ((16384 + 37, 512, 100), None), ((4096 + 5, 200, 512), 150),
                 ((64, 512, 256), 1), ((1, 1, 256), None),
             ])]
    cases.append(("uniform (256, 512, 256) valid_n 300, int32 on the card",
                  pair_inputs(256, 512, 1, 256, 220, device)[:2],
                  torch.tensor(300, dtype=torch.int32, device=device), False))
    cases.append(("near-binary, exact duplicates "
                  f"{SINGLE_SHAPE}", near_binary_inputs(
                      SINGLE_SHAPE[0], SINGLE_SHAPE[1], 1, SINGLE_SHAPE[2],
                      210, device)[:2], None, True))
    cases.append(("near-binary, near duplicates "
                  f"{SINGLE_SHAPE}", near_binary_inputs(
                      SINGLE_SHAPE[0], SINGLE_SHAPE[1], 1, SINGLE_SHAPE[2],
                      211, device, exact_archive=False)[:2], None, True))
    if real is not None:
        feats, archive, _, an, _ = real
        cases.append((f"main-path feature rows {tuple(feats.shape)} "
                      f"archive_n {an}", (feats, archive), an, False))
    max_err = 0.0
    for label, tensors, vn, cancels in cases:
        max_err = max(max_err, check_case(
            "single kernel", pd.min_sq_distance, pd.min_sq_distance_reference,
            tensors, {"valid_n": vn}, label, cancels))
    out = {
        "name": "min_sq",
        "route": "cuda",
        "source": "namazu_tpu_torch/csrc/min_sq_pair.cu",
        "replaces": "namazu_tpu/ops/pallas_score.py:54",
        "launches": None,
        "max_abs_err": max_err,
    }
    if timed:
        N, A, Kc = SINGLE_SHAPE
        feats, archive, _ = pair_inputs(N, A, 1, Kc, 8, device)
        out.update(timing(
            lambda: pd.min_sq_distance(feats, archive),
            lambda: pd.min_sq_distance_reference(feats, archive),
            lambda: torch.cdist(feats, archive).square().amin(1),
            bounds_ms(N, A, Kc, 1)))
        report("single kernel", SINGLE_SHAPE, out, max_err)
    return out


def plan_of(pd, shape) -> dict:
    """The grid plan of B1 at ``shape`` on this card, printed with the
    card's limits it was made from (SMs; clusters of (consumers, split)
    the card runs at once)."""
    import torch

    N, A, F, Kc = shape
    plan = pd.card_plan(torch.device("cuda"), N, A, F, Kc)
    sms, clusters = pd.card_limits(torch.device("cuda"), Kc)
    out = dict(plan._asdict(), blocks=plan.blocks, sms=sms,
               clusters_at_once={f"{c}x{s}": n for c, s, n in clusters})
    print(f"  plan at {shape}: {plan.row_tiles} row tiles, split "
          f"{plan.split}, {plan.blocks} blocks of {plan.bm} rows, "
          f"{plan.steps} steps a block (busiest rank), {plan.waves} "
          f"wave(s), ranges {list(plan.ranges)}; {sms} SMs, clusters at "
          f"once (warpgroups x split) {out['clusters_at_once']}")
    return out


def kernels_a_call(fn) -> tuple:
    """``(CUDA kernels, their device ms)`` of one warm call of ``fn``
    under torch.profiler."""
    prof = device_profile(fn, 1)
    return int(prof["launches"]), prof["device_ms"]


def check_pair_kernel(device, real=None, timed=True) -> dict:
    import torch

    from namazu_tpu_torch.ops import pair_distance as pd

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def on_card(n):  # an occupancy the kernel reads on the card
        return torch.tensor(n, dtype=torch.int32, device=device)

    cases = [(f"uniform {s} occ {(an, fn)}", pair_inputs(*s, 100 + i, device),
              an, fn, False)
             for i, (s, an, fn) in enumerate([
                 (MAIN_SHAPE, None, None),
                 (MAIN_SHAPE, 300, 0),
                 (MAIN_SHAPE, 0, 17),
                 ((33, 7, 5, 64), None, None),
                 ((33, 7, 5, 64), 3, 0),
                 ((300, 100, 7, 128), 100, 7),
                 ((300, 100, 7, 128), 50, 1),
                 ((16384 + 37, 512, 1, 100), None, None),
                 ((4096 + 5, 200, 9, 512), 150, 9),
                 (ROLLOUT_SHAPES[0], None, None),
                 (ROLLOUT_SHAPES[0], 300, 17),
                 (ROLLOUT_SHAPES[1], None, None),
                 (ROLLOUT_SHAPES[1], 300, 17),
                 (TREES_SHAPE, None, None),
                 (TREES_SHAPE, 300, 17),
                 (BENCH_SHAPE, None, None),
                 (BENCH_SHAPE, 700, 33),
                 # every rank but the first masked (archive), the failure
                 # tile's rank masked whole
                 (ROLLOUT_SHAPES[0], 1, 0),
                 (ROLLOUT_SHAPES[1], 1, 0),
                 ((256, 1, 1, 256), None, None),
                 ((64, 1, 1, 256), 1, 0),
                 ((1, 1, 1, 256), None, None),
             ])]
    for i, (s, an, fn) in enumerate([(ROLLOUT_SHAPES[0], 300, 17),
                                     (BENCH_SHAPE, 700, 33),
                                     (MAIN_SHAPE, 300, 0)]):
        cases.append((f"uniform {s} occ {(an, fn)}, int32 on the card",
                      pair_inputs(*s, 120 + i, device), on_card(an),
                      on_card(fn), False))
    for i, exact in enumerate((True, False)):
        what = "exact archive, near failures" if exact else \
            "near archive, exact failures"
        cases.append((f"near-binary, {what} {MAIN_SHAPE}",
                      near_binary_inputs(*MAIN_SHAPE, 110 + i, device,
                                         exact_archive=exact), None, None,
                      True))
    if real is not None:
        feats, archive, failures, an, fn = real
        cases.append((f"main-path feature rows {tuple(feats.shape)}",
                      (feats, archive, failures), None, None, False))
        cases.append((f"main-path feature rows occ {(an, fn)}",
                      (feats, archive, failures), an, fn, False))
    max_err = 0.0
    for label, tensors, an, fn, cancels in cases:
        max_err = max(max_err, check_case(
            "pair kernel", pd.min_sq_distance_pair,
            pd.min_sq_distance_pair_reference, tensors,
            {"archive_n": an, "failure_n": fn}, label, cancels))
    feats, archive, failures = pair_inputs(*MAIN_SHAPE, 12, device)
    dev = torch.device(device)
    check(pd.card_plan(dev, 64, *MAIN_SHAPE[1:]).split > 1
          and pd.card_plan(dev, *MAIN_SHAPE).split == 1,
          "rows [:64] and the main shape share a grid")
    for occ in ((None, None), (300, 17)):
        full = pd.min_sq_distance_pair(feats, archive, failures, *occ)
        part = pd.min_sq_distance_pair(feats[:64], archive, failures, *occ)
        diff = max(float((x[:64] - y).abs().max()) for x, y in zip(full, part))
        print(f"  rows [:64] alone (split) against inside the main shape's "
              f"launch (unsplit), occ {occ}: largest difference {diff}")
        check(all(torch.equal(x[:64], y) for x, y in zip(full, part)),
              f"rows [:64] differ across grids by up to {diff}")
    del feats, archive, failures
    out = {
        "name": "min_sq_pair",
        "route": "cuda",
        "source": "namazu_tpu_torch/csrc/min_sq_pair.cu",
        "replaces": "namazu_tpu/ops/pallas_score.py:157",
        "launches": None,
        "max_abs_err": max_err,
    }
    if not timed:
        return out
    for shape, seed, key in ((MAIN_SHAPE, 7, None),
                             (ROLLOUT_SHAPES[0], 9, "N=256"),
                             (ROLLOUT_SHAPES[1], 9, "N=64"),
                             (TREES_SHAPE, 11, "N=2048"),
                             (BENCH_SHAPE, 10, None)):
        N, A, F, Kc = shape
        f, a, fl = pair_inputs(N, A, F, Kc, seed, device)
        t = {"plan": plan_of(pd, shape)}
        t.update(timing(
            lambda: pd.min_sq_distance_pair(f, a, fl),
            lambda: pd.min_sq_distance_pair_reference(f, a, fl),
            lambda: (torch.cdist(f, a).square().amin(1),
                     torch.cdist(f, fl).square().amin(1)),
            bounds_ms(N, A + F, Kc, 2)))
        report("pair kernel", shape, t, max_err)
        t["kernels_a_call"], t["profiled_ms"] = {}, {}
        for what, occ in (("none", (None, None)),
                          ("int32 on the card", (on_card(300),
                                                 on_card(17)))):
            n, ms = kernels_a_call(
                lambda: pd.min_sq_distance_pair(f, a, fl, *occ))
            t["kernels_a_call"][what], t["profiled_ms"][what] = n, ms
            check(n == 1, f"one B1 call at {shape} with occupancies {what} "
                          f"made {n} CUDA kernels, expected 1")
        print(f"  kernels a B1 call at {shape}: {t['kernels_a_call']}, "
              f"their device ms under the profiler {t['profiled_ms']}")
        if key is not None:
            # the other block height
            plan = pd.card_plan(dev, N, A, F, Kc)
            sms, clusters = pd.card_limits(dev, Kc)
            alt = pd._plan(N, A, F, Kc, sms, 3 - plan.consumers, clusters)
            got = pd.min_sq_distance_pair(f, a, fl)
            other = pd._launch(f, a, fl, None, None, plan=alt)
            check(all(torch.equal(x, y) for x, y in zip(got, other)),
                  f"bm {alt.bm} and the plan's bm {plan.bm} differ at "
                  f"{shape}")
            t["other_bm"] = {"plan": dict(alt._asdict(), blocks=alt.blocks),
                             "ms": device_time_ms(lambda: pd._launch(
                                 f, a, fl, None, None, plan=alt))}
            print(f"  bm {alt.bm} at {shape} ({alt.blocks} blocks, split "
                  f"{alt.split}): kernel_ms {t['other_bm']['ms']:.5f}, "
                  f"equal to the plan's bit for bit")
        if shape == MAIN_SHAPE:
            out.update(t)
        elif key is not None:
            out.setdefault("at_rollout_shapes", {})[key] = t
        else:
            out["at_bench_shape"] = t
    return out


# -- phase 3: the main path -------------------------------------------------


def cluster_flows(nodes: int = 13, n_flows: int = 150):
    """The ``(src, dst)`` flows of the synthetic cluster, in a fixed
    order."""
    return [(s, d) for s in range(nodes) for d in range(nodes)
            if s != d][:n_flows]


def synthetic_stream(rng, n_events: int, n_flows: int = 150,
                     jitter: float = 0.0):
    """A seeded stream of packet-like events over ``n_flows`` flows of a
    13-node cluster, Zipf-skewed, with ~1 ms inter-arrivals; ``jitter``
    adds per-event release noise (an executed run's realized view)."""
    flows = cluster_flows(n_flows=n_flows)
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


def rescore_on_cpu(search, refs, delays, faults=None):
    """The fitness of one table (and, where the search scores faults, its
    fault half) re-scored on the CPU by the plain versions, with the
    search's pairs, archives, weights and coin."""
    import numpy as np
    import torch

    from namazu_tpu_torch.ops import schedule as sched
    from namazu_tpu_torch.ops import trace_encoding as te

    h, _, a, m, fb = te.stack_traces(refs)
    coin = None if search._coin is None else torch.from_numpy(search._coin)
    traces = sched.TraceArrays(torch.from_numpy(h).long(),
                               torch.from_numpy(a), torch.from_numpy(m),
                               None if coin is None else
                               torch.from_numpy(fb))
    nov = getattr(search, "novelty_scale", None)
    fit, _ = sched.score_population_multi(
        torch.from_numpy(np.asarray(delays, np.float32)[None]), traces,
        torch.from_numpy(search.pairs), torch.from_numpy(search.archive),
        torch.from_numpy(search.failures), search.cfg.weights,
        faults=None if coin is None else torch.from_numpy(
            np.asarray(faults, np.float32)[None]),
        coin=coin, novelty_scale=None if nov is None else nov())
    return float(fit[0])


def drive_main_path(device, generations=GENERATIONS, built=None, **sizes):
    """Two ``run()`` calls of the search (``built``: a ``(search, refs)``
    from :func:`build_search`, else one is built from ``sizes``); returns
    the kernel launches they made, the search and its reference traces."""
    from namazu_tpu_torch.ops import pair_distance as pd

    t0 = time.perf_counter()
    search, refs = built or build_search(device, **sizes)
    setup = "prebuilt" if built else f"{time.perf_counter() - t0:.2f} s"
    L = refs[0].hint_ids.shape[0]
    print(f"  setup {setup}: {len(refs)} reference traces of "
          f"L={L}, archive {search._archive_n}, failures "
          f"{search._failure_n}")
    if device != "cpu":
        import torch

        torch.cuda.synchronize()
    pd.LAUNCHES = pd.SINGLE_LAUNCHES = 0  # count only this path's
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


def device_profile(fn, steps: int) -> dict:
    """``fn`` traced once by torch.profiler after one warm call: wall and
    device ms per step, the device's busy share, launches per step and
    the six costliest kernels."""
    import torch

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # the island step's record_function ranges show on the device's
    # timeline too, as annotations that are not kernels
    ranges = {e.name for e in prof.events()
              if getattr(e, "is_user_annotation", False)}
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.key not in ranges]
    check(not [e.key for e in kernels if e.key in NMZ_RANGES],
          "the island step's ranges were counted as kernels")
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    return {
        "wall_ms": wall_ms / steps,
        "device_ms": busy_ms / steps,
        "device_busy_share": busy_ms / wall_ms if busy_ms else None,
        "launches": sum(e.count for e in kernels) / steps,
        # torch's RNG kernels (uniform, normal, randint) a step
        "rng_launches": sum(e.count for e in kernels
                            if "distribution" in e.key) / steps,
        "top_kernels_ms": {e.key[:80]: e.self_device_time_total / 1e3
                           / steps for e in top},
    }


def profile_generation(search, refs) -> dict:
    """Where a generation's time goes at the search's sizes and settings
    (its weights, and its fault half where it scores one): each layer
    timed alone by CUDA events, and one fused_chunk of generations traced
    by torch.profiler for the device's busy share."""
    from namazu_tpu_torch.models.ga import ga_generation
    from namazu_tpu_torch.ops import schedule as sched
    from namazu_tpu_torch.ops.pair_distance import min_sq_distance_pair
    from namazu_tpu_torch.parallel.islands import fused_step, generator_for

    traces, pairs, archive, failures = search._device_inputs(refs)
    cfg, st, w, coin = (search.cfg, search._state, search.cfg.weights,
                        search._dev_coin)
    faults = None if coin is None else st.pop.faults

    def features():
        return sched._genome_features(
            st.pop.delays, traces, pairs, w.tau, w.order_mode, w.order_gap,
            w.order_window, faults=faults, coin=coin)

    flat = features()[0].reshape(-1, cfg.K)
    fitness, _ = sched.score_population_multi(
        st.pop.delays, traces, pairs, archive, failures, w, faults=faults,
        coin=coin)
    gen = generator_for(search._seed, st.gen, search.device)
    out = {
        "feature_step_ms": cuda_time_ms(features, iters=20),
        "pair_kernel_ms": cuda_time_ms(
            lambda: min_sq_distance_pair(flat, archive, failures), iters=20),
        "ga_ms": cuda_time_ms(lambda: ga_generation(
            gen, st.pop, fitness, cfg.ga), iters=20),
    }
    chunk = cfg.fused_chunk
    prof = device_profile(
        lambda: fused_step(search._state, chunk, search._seed, traces,
                           pairs, archive, failures, cfg.ga, w, coin=coin),
        chunk)
    out["generation_wall_ms"] = prof["wall_ms"]
    out["generation_device_ms"] = prof["device_ms"]
    out["device_busy_share"] = prof["device_busy_share"]
    out["launches_per_generation"] = prof["launches"]
    out["top_kernels_ms_per_generation"] = prof["top_kernels_ms"]
    return out


def profile_mcts(search, refs) -> dict:
    """One search of the MCTS path at its own inputs, timed without the
    profiler (simulations/s) and traced once by torch.profiler: device
    time and launches a simulation, and the device's busy share (the rest
    is the host: the tree, the launches and one sync a simulation)."""
    import torch

    from namazu_tpu_torch.models.mcts import mcts_search

    traces, pairs, archive, failures = search._device_inputs(refs)
    seeds = (None if search._seed_tables is None else
             torch.from_numpy(search._seed_tables).to(search.device))
    order = search._hint_order(refs)
    sims = search.mcts_cfg.simulations

    def run():
        mcts_search(12345, traces, pairs, archive, failures, order,
                    search.cfg.H, search.mcts_cfg, search.cfg.weights,
                    coin=search._dev_coin, seeds=seeds)

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    prof = device_profile(run, sims)
    out = {"search_s": wall, "simulations_per_s": sims / wall,
           "rollouts_per_s": sims * search.mcts_cfg.rollouts / wall}
    out.update({f"simulation_{k}" if k != "device_busy_share" else k: v
                for k, v in prof.items()})
    print(f"  one search alone: {wall:.4f} s, {sims / wall:.1f} "
          f"simulations/s; under the profiler a simulation takes "
          f"{prof['wall_ms']:.3f} ms of wall, {prof['device_ms']:.3f} ms "
          f"of device time, {prof['launches']:.1f} launches")
    return out


# -- phase 5: the sidecar path ----------------------------------------------


def write_history(root, runs=HISTORY_RUNS, failures=HISTORY_FAILURES,
                  events=EVENTS, seed=1, proc_every=0, successes=0):
    """A naive storage directory as namazu_tpu's control plane writes it:
    ``runs`` recorded runs of ``events`` actions each (the reference's
    action dicts, arrival and release stamped), the last of every ``runs
    // failures`` a failure whose releases carry up to 50 ms of injected
    delay (successes up to 2 ms), results stamped with the hint space.
    With ``successes`` the outcomes flip: the last of every ``runs //
    successes`` succeeds and the rest fail. Events are packets; with
    ``proc_every`` the events of every ``proc_every``-th flow record as
    ProcSetEvent, a class that carries no fault. Returns the directory."""
    import numpy as np

    from namazu_tpu_torch.ops.trace_encoding import HINT_SPACE

    flow_of = {f"10.0.0.{s}->10.0.0.{d}": i
               for i, (s, d) in enumerate(cluster_flows())}

    def event_class(hint):
        if proc_every and (flow_of[hint.split(":")[0]] % proc_every
                           == proc_every - 1):
            return "ProcSetEvent"
        return "PacketEvent"

    rng = np.random.RandomState(seed)
    os.makedirs(root)
    with open(os.path.join(root, "storage.json"), "w") as f:
        json.dump({"type": "naive", "next_run": runs}, f)
    every = runs // (successes or failures)
    for r in range(runs):
        ok = (r % every != every - 1) != bool(successes)
        hints, arrivals = synthetic_stream(rng, events)
        t0 = 1.7e9 + 60.0 * r
        released = np.asarray(arrivals) + rng.rand(events) * (
            0.002 if ok else 0.05)
        actions = [{
            "type": "action", "class": "EventAcceptanceAction",
            "entity": hint.split("->")[0], "uuid": f"a{r:03d}-{i:05d}",
            "option": {}, "event_uuid": f"e{r:03d}-{i:05d}",
            "event_class": event_class(hint), "event_hint": hint,
            "event_arrived": t0 + arr, "triggered_time": t0 + float(rel),
        } for i, (hint, arr, rel) in enumerate(zip(hints, arrivals,
                                                   released))]
        run_dir = os.path.join(root, f"{r:08x}")
        os.makedirs(run_dir)
        with open(os.path.join(run_dir, "trace.json"), "w") as f:
            json.dump(actions, f)
        with open(os.path.join(run_dir, "result.json"), "w") as f:
            json.dump({"successful": ok, "required_time": 1.0,
                       "metadata": {"hint_space": HINT_SPACE}}, f)
    return root


def newest_references(storage_dir, n=4, H=H, L=None):
    """The references ingest evolves against: the newest successful runs'
    arrival views, newest first (``L``: ingest's length cap)."""
    from namazu_tpu_torch.history import load_storage
    from namazu_tpu_torch.ops import trace_encoding as te

    st = load_storage(storage_dir)
    ok = [i for i in range(st.nr_stored_histories()) if st.is_successful(i)]
    return [te.encode_trace(st.get_stored_history(i), L=L, H=H)
            for i in ok[::-1][:n]]


def time_host_ingest(storage_dir, H=H) -> None:
    """The host half of one ingest timed alone: reading every run's JSON,
    then encoding both views (one fnv64a in Python per event)."""
    from namazu_tpu_torch.history import load_storage
    from namazu_tpu_torch.ops import trace_encoding as te

    t0 = time.perf_counter()
    st = load_storage(storage_dir)
    runs = [st.get_stored_history(i)
            for i in range(st.nr_stored_histories())]
    t1 = time.perf_counter()
    for trace in runs:
        te.encode_trace_views(trace, H=H)
    t2 = time.perf_counter()
    events = sum(len(r) for r in runs)
    print(f"  ingest's host half alone: reading {len(runs)} runs "
          f"{t1 - t0:.3f} s, encoding {events} events (fnv64a in Python) "
          f"{t2 - t1:.3f} s ({(t2 - t1) / events * 1e6:.2f} us/event)")


def sidecar_requests(device, work_dir, storage, generations=GENERATIONS,
                     search_params=None, ingest_params=None, walls=None):
    """Two search requests over one keep-alive connection to the port's
    sidecar on ``device``, the launch counts set to 0 just before them
    and read just after, and the checks every path shares: generations,
    tables, checkpoint keys, B1's launches and a re-score on the CPU of
    the returned table; each request's wall is appended to ``walls``
    when given. Returns ``(launches, search, references, the second
    response)``."""
    import numpy as np

    from namazu_tpu_torch import wire
    from namazu_tpu_torch.ops import pair_distance as pd
    from namazu_tpu_torch.sidecar import SidecarServer

    sp = search_params or POLICY_SEARCH_PARAMS
    ip = ingest_params or POLICY_INGEST_PARAMS
    ckpt = os.path.join(work_dir, "search.npz")
    if os.path.exists(ckpt):
        os.remove(ckpt)
    req = {
        "op": "search", "key": storage, "storage": storage,
        "search_params": sp, "ingest_params": ip,
        "generations": generations, "checkpoint": ckpt,
    }
    mcts = sp.get("search_backend") == "mcts"
    server = SidecarServer("127.0.0.1", 0, device=device)
    server.start()
    try:
        if device != "cpu":
            import torch

            torch.cuda.synchronize()
        pd.LAUNCHES = pd.SINGLE_LAUNCHES = 0
        resps = []
        with socket.create_connection(("127.0.0.1", server.port)) as sock:
            for r in range(2):
                t0 = time.perf_counter()
                wire.write_frame(sock, req)
                resp = wire.read_frame(sock)
                wall = time.perf_counter() - t0
                check(resp is not None and resp.get("ok") is True,
                      f"sidecar request {r} failed: {resp}")
                resps.append(resp)
                if walls is not None:
                    walls.append(wall)
                tm = server.service.timings[storage]
                search = server.service.search_for(storage)
                if mcts:
                    sims = search.mcts_cfg.simulations * max(
                        1, generations // 64)
                    rate = (f"{sims / tm['run']:.1f} simulations/s, "
                            f"{sims * search.mcts_cfg.rollouts / tm['run']:.1f}"
                            f" rollouts/s")
                else:
                    rate = (f"{search.population * generations / tm['run']:.1f}"
                            f" schedules/s")
                print(f"  request {r}: ingest {tm['ingest']:.3f} s, run "
                      f"{tm['run']:.4f} s ({rate}), "
                      f"re-rank {tm['rerank'] * 1e3:.2f} ms, "
                      f"save {tm['save']:.3f} s, wall {wall:.3f} s; "
                      f"fitness {resp['fitness']:.6f}, generations_run "
                      f"{resp['generations_run']}")
        launches = {"min_sq_pair": pd.LAUNCHES, "min_sq": pd.SINGLE_LAUNCHES}
    finally:
        server.shutdown()
    r0, r1 = resps
    if mcts:
        step = search.mcts_cfg.simulations * max(1, generations // 64)
        keys = MCTS_CHECKPOINT_KEYS
        expect = 2 * step
    else:
        step = generations
        keys = CHECKPOINT_KEYS
        check(search._surrogate is not None, "the surrogate did not train")
        expect = 2 * generations + 2  # once a generation, once a re-rank
    check([r0["generations_run"], r1["generations_run"]] == [step, 2 * step],
          "generations_run is wrong")
    for r in resps:
        check(len(r["delays"]) == search.cfg.H
              and len(r["faults"]) == search.cfg.H
              and math.isfinite(r["fitness"]), "bad table in a response")
    with np.load(ckpt) as z:
        missing = [k for k in keys if k not in z.files]
        backend = str(z["backend"])
    check(not missing, f"checkpoint lacks {missing}")
    check(backend == search.BACKEND, f"checkpoint backend {backend}")
    if device != "cpu":
        check(launches["min_sq_pair"] == expect,
              f"pair kernel launched {launches['min_sq_pair']} times on "
              f"this path, expected {expect}")
    cap = (ip.get("order_mode_max_l") if ip.get("release_mode") == "reorder"
           else None)
    refs = newest_references(storage, H=search.cfg.H, L=cap)
    rescored = rescore_on_cpu(search, refs, r1["delays"], r1["faults"])
    check(math.isclose(rescored, r1["fitness"], rel_tol=RTOL,
                       abs_tol=ATOL),
          f"re-scored fitness {rescored} != returned {r1['fitness']}")
    print(f"  returned table re-scored on the CPU: {rescored:.6f} "
          f"(returned {r1['fitness']:.6f}; best seen "
          f"{search.best().fitness:.6f})")
    return launches, search, refs, r1


def drive_sidecar_path(device, work_dir, generations=GENERATIONS,
                       search_params=None, ingest_params=None, walls=None,
                       **history):
    """Phase 5: a history written under ``work_dir`` and two requests at
    the policy's defaults (their walls appended to ``walls`` when given);
    returns the kernel launches they made."""
    t0 = time.perf_counter()
    storage = write_history(os.path.join(work_dir, "history"), **history)
    print(f"  wrote {storage}: {time.perf_counter() - t0:.2f} s")
    launches, search, _, _ = sidecar_requests(
        device, work_dir, storage, generations, search_params,
        ingest_params, walls)
    time_host_ingest(storage, search.cfg.H)
    return launches


KNOWLEDGE_SCENARIO = "chip-smoke"  # the one scenario of both campaigns
COLD_SUCCESSES = 1  # campaign B: a cold storage of mostly failures


def drive_knowledge_path(device, work_dir, generations=GENERATIONS,
                         search_params=None, ingest_params=None,
                         history_a=None, **history):
    """The knowledge and guidance path: one port sidecar hosting its
    knowledge service over a pool under ``work_dir``, and two campaigns
    of one scenario with every knob of the policy's request on
    (guidance in search and ingest, a failure pool of their own, the
    knowledge service at the sidecar's own address), two requests each
    over one keep-alive connection. Campaign A evolves on ``history_a``
    (phase 5's history; written here when None), its requests carrying
    ``device_trace_dir``; campaign B is a cold storage whose runs mostly
    fail, so its own successes are too few for its local surrogate and
    its re-rank asks the shared one. Every check is fatal. Returns
    ``({path: launches}, numbers)``."""
    import numpy as np

    from namazu_tpu_torch import wire
    from namazu_tpu_torch.knowledge import KnowledgeService, shared_client
    from namazu_tpu_torch.ops import pair_distance as pd
    from namazu_tpu_torch.sidecar import SidecarServer

    t0 = time.perf_counter()
    os.makedirs(work_dir, exist_ok=True)
    if history_a is None:
        history_a = write_history(os.path.join(work_dir, "history"),
                                  **history)
    history.pop("failures", None)
    cold = write_history(os.path.join(work_dir, "history-cold"), seed=3,
                         successes=COLD_SUCCESSES, **history)
    print(f"  campaign A on {history_a}; wrote cold storage {cold} "
          f"({COLD_SUCCESSES} successes): {time.perf_counter() - t0:.2f} s")
    trace_dir = os.path.join(work_dir, "trace")
    server = SidecarServer("127.0.0.1", 0, device=device,
                           knowledge=KnowledgeService(
                               os.path.join(work_dir, "knowledge-pool"),
                               device=device))
    server.start()
    addr = f"127.0.0.1:{server.port}"
    sp0 = dict(search_params or POLICY_SEARCH_PARAMS, guidance=True)
    launches, numbers = {}, {}
    try:
        for name, storage, extra in (
                ("knowledge_a", history_a, {"device_trace_dir": trace_dir}),
                ("knowledge_b", cold, {})):
            tenant = name[-1]
            ip = dict(ingest_params or POLICY_INGEST_PARAMS, guidance=True,
                      failure_pool=os.path.join(work_dir, f"pool-{tenant}"),
                      knowledge=addr, knowledge_tenant=tenant,
                      knowledge_scenario=KNOWLEDGE_SCENARIO)
            ckpt = os.path.join(work_dir, f"search-{tenant}.npz")
            req = {"op": "search", "key": storage, "storage": storage,
                   "search_params": dict(sp0, **extra), "ingest_params": ip,
                   "generations": generations, "checkpoint": ckpt}
            sync(device)
            pd.LAUNCHES = pd.SINGLE_LAUNCHES = 0
            resps, walls, warm = [], [], []
            with socket.create_connection(("127.0.0.1", server.port)) as sk:
                for r in range(2):
                    t0 = time.perf_counter()
                    wire.write_frame(sk, req)
                    resp = wire.read_frame(sk)
                    walls.append(time.perf_counter() - t0)
                    check(resp is not None and resp.get("ok") is True,
                          f"{name} request {r} failed: {resp}")
                    resps.append(resp)
                    search = server.service.search_for(storage)
                    tm = dict(server.service.timings[storage])
                    warm.append(dict(server.service.ingest_counts[storage]))
                    refs = newest_references(storage, H=search.cfg.H)
                    rescored = rescore_on_cpu(search, refs, resp["delays"],
                                              resp["faults"])
                    check(math.isclose(rescored, resp["fitness"],
                                       rel_tol=RTOL, abs_tol=ATOL),
                          f"{name} request {r}: re-scored fitness "
                          f"{rescored} != returned {resp['fitness']}")
                    split = ", ".join(f"{k[7:]} {v:.3f}" for k, v in
                                      sorted(tm.items())
                                      if k.startswith("ingest_"))
                    print(f"  {name} request {r}: wall {walls[-1]:.3f} s; "
                          f"ingest {tm['ingest']:.3f} s ({split}); run "
                          f"{tm['run']:.4f} s, re-rank "
                          f"{tm['rerank'] * 1e3:.2f} ms, save "
                          f"{tm['save']:.3f} s; ingest counts {warm[-1]}; "
                          f"fitness {resp['fitness']:.6f} (re-scored on "
                          f"the CPU {rescored:.6f})")
                    if name == "knowledge_a":
                        n = len(os.listdir(os.path.join(trace_dir,
                                                        "device_trace")))
                        check(n == 1, f"{n} device traces after request "
                                      f"{r}, expected 1")
                    numbers.setdefault(name, []).append(
                        dict(tm, wall=walls[-1]))
            launches[name] = {"min_sq_pair": pd.LAUNCHES,
                              "min_sq": pd.SINGLE_LAUNCHES}
            # the client the sidecar's ingest and re-rank share
            seen = shared_client(addr, tenant=tenant,
                                 scenario=KNOWLEDGE_SCENARIO).counts
            if device != "cpu":
                check(launches[name]["min_sq_pair"] == 2 * generations + 2,
                      f"pair kernel launched {launches[name]['min_sq_pair']}"
                      f" times on {name}, expected {2 * generations + 2}")
            check([x["generations_run"] for x in resps]
                  == [generations, 2 * generations],
                  "generations_run is wrong")
            bias = search.guidance.mutation_bias()
            check(float(bias.max()) > 1.0, "the mutation bias is flat")
            keys = CHECKPOINT_KEYS if name == "knowledge_a" else tuple(
                k for k in CHECKPOINT_KEYS if k != "surrogate_params")
            with np.load(ckpt) as z:
                missing = [k for k in keys if k not in z.files]
                gshape = (z["guidance_feats"].shape
                          if "guidance_feats" in z.files else None)
            check(not missing, f"{name} checkpoint lacks {missing}")
            check(gshape == (search.cfg.archive_size, 20),
                  f"{name} checkpoint guidance_feats {gshape}")
            if name == "knowledge_a":
                check(search._surrogate is not None,
                      "campaign A's local surrogate did not train")
            else:
                check(search._surrogate is None,
                      "campaign B's local surrogate trained")
                check(warm[0].get("warmstart_archive", 0) > 0
                      and warm[0].get("warmstart_coverage", 0) > 0,
                      f"campaign B's first ingest warm-started nothing: "
                      f"{warm[0]}")
                check(seen.get("predicts_trained", 0) == 2,
                      f"campaign B's re-ranks were not both answered by "
                      f"a trained shared surrogate: {seen}")
            print(f"  {name}: B1 launches {launches[name]}, mutation bias "
                  f"max {bias.max():.3f}, coverage "
                  f"{search.guidance.covered()} bits, knowledge client "
                  f"counts {seen}")
        stats = wire.request(addr, {"op": "stats"})
        check(set(stats["tenants"]) >= {"a", "b"},
              f"stats lack a tenant: {sorted(stats['tenants'])}")
        print(f"  knowledge stats: pool {stats['pool_size']}, tenants "
              f"{sorted(stats['tenants'])}, surrogate {stats['surrogate']},"
              f" coverage {list(stats['coverage'].values())}")
    finally:
        server.shutdown()
    return launches, numbers


def memory_and_time(fn, device) -> dict:
    """``fn``'s time alone (CUDA events) and the peak device memory one
    call allocates beyond what was live before it."""
    import torch

    torch.cuda.synchronize(device)
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    fn()
    torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device) - base
    return {"ms": cuda_time_ms(fn, iters=10, warmup=2),
            "peak_bytes": int(peak)}


def order_feature_steps(search, refs) -> dict:
    """The order path's feature step timed alone, with its peak device
    memory, at L = 2048 and at the path's own L (ingest's cap)."""
    from namazu_tpu_torch.ops import schedule as sched

    traces = search._device_inputs(refs)[0]
    pairs, pop, w = search._dev_pairs, search._state.pop, search.cfg.weights

    def step(tr):
        return lambda: sched._genome_features(
            pop.delays, tr, pairs, w.tau, w.order_mode, w.order_gap,
            w.order_window)

    short = sched.TraceArrays(*(x[:, :2048].contiguous()
                                for x in traces[:3]))
    out = {}
    for tr in (short, traces):
        L = tr.hint_ids.shape[-1]
        v = out[f"order_feature_step_L{L}"] = memory_and_time(
            step(tr), search.device)
        print(f"  order-mode feature step at {tuple(pop.delays.shape)} x "
              f"{len(refs)} traces x L={L}: {v['ms']:.3f} ms, peak "
              f"{v['peak_bytes'] / 2**30:.3f} GiB beyond what was live")
    return out


def drive_extra_paths(device, work_dir, generations=GENERATIONS,
                      search_params=None, ingest_params=None, **history):
    """Phases 6-8 over one history whose every fourth flow records as
    ProcSetEvent: the fault path, the order path and the MCTS path, each
    two requests with its own launch counts. Returns ``({path:
    launches}, {path: numbers})``."""
    import numpy as np

    t0 = time.perf_counter()
    storage = write_history(os.path.join(work_dir, "history-mixed"),
                            proc_every=4, **history)
    print(f"  wrote {storage} (every fourth flow ProcSetEvent): "
          f"{time.perf_counter() - t0:.2f} s")
    launches, numbers = {}, {}
    for name, sp_extra, ip_extra in EXTRA_PATHS:
        print(f"phase: {name}")
        sp = dict(search_params or POLICY_SEARCH_PARAMS, **sp_extra)
        ip = dict(ingest_params or POLICY_INGEST_PARAMS, **ip_extra)
        launches[name], search, refs, resp = sidecar_requests(
            device, work_dir, storage, generations, sp, ip)
        faults = np.asarray(resp["faults"], np.float32)
        if name == "sidecar_faults":
            flt = np.concatenate([r.faultable[r.mask] for r in refs])
            check(0.0 < flt.mean() < 1.0, "the faultable flag is uniform")
            check(search._coin is not None, "no fault coin")
            check(faults.min() >= 0.0 and faults.max() <= np.float32(
                sp["max_fault"]) and faults.any(),
                f"fault table outside [0, {sp['max_fault']}] or all zero")
            print(f"  returned fault table: {int((faults > 0).sum())} of "
                  f"{faults.size} buckets > 0, max {faults.max():.4f}; "
                  f"faultable share of reference events {flt.mean():.3f}")
        else:
            check(not faults.any(), "faults returned without a fault half")
        if device != "cpu" and name == "sidecar_mcts":
            numbers[name] = profile_mcts(search, refs)
        elif device != "cpu":
            numbers[name] = {"generation": profile_generation(search, refs)}
            if name == "sidecar_order":
                numbers[name].update(order_feature_steps(search, refs))
        del search, refs
    return launches, numbers


# -- phases 9-10: the island model -----------------------------------------


ISLANDS = 8  # phase 9: 8 islands of 512 on the card (BASELINE config 4)
HYBRID_HOSTS = 2  # phase 10: a 2 x 4 hybrid mesh (config 5's layout)
MARK = 0.0123  # a delay no evolved row holds exactly
SYNC_WARNING = "called a synchronizing CUDA operation"


def island_search(device, storage, sp, ip, mesh):
    """A search built from the policy's params over ``mesh`` and fed the
    history, as the sidecar builds and feeds one; returns ``(search,
    references)``."""
    from namazu_tpu_torch.history import load_storage
    from namazu_tpu_torch.models.ingest import ingest_history
    from namazu_tpu_torch.policy.tpu import build_search, ingest_params

    search = build_search(sp, device, mesh=mesh)
    return search, ingest_history(search, load_storage(storage),
                                  ingest_params(ip))


def sync(device) -> None:
    if device != "cpu":
        import torch

        torch.cuda.synchronize()


def drive_island_path(name, device, storage, sp, ip, mesh, generations):
    """Two ``run()`` calls of a search over ``mesh``, the launch counts
    set to 0 just before them and read just after; B1 must launch once a
    shard and generation and once a re-rank, and the returned table
    re-scored on the CPU must give the returned fitness. Returns
    ``(launches, search, references, numbers)``."""
    import numpy as np

    from namazu_tpu_torch.ops import pair_distance as pd

    t0 = time.perf_counter()
    search, refs = island_search(device, storage, sp, ip, mesh)
    print(f"  {name}: {mesh}, population {search.population}, rings "
          f"{search._rings}; built and ingested in "
          f"{time.perf_counter() - t0:.2f} s")
    sync(device)
    pd.LAUNCHES = pd.SINGLE_LAUNCHES = 0
    bests, rates = [], []
    for r in range(2):
        best = search.run(refs, generations=generations)
        secs = search.last_run_seconds
        bests.append(best)
        rates.append(search.population * generations / secs)
        print(f"  run {r}: fitness {best.fitness:.6f} (best seen "
              f"{search.best().fitness:.6f}), {secs:.4f} s, "
              f"{generations / secs:.2f} generations/s, {rates[-1]:.1f} "
              f"schedules/s, re-rank "
              f"{search.last_rerank_seconds * 1e3:.2f} ms")
    launches = {"min_sq_pair": pd.LAUNCHES, "min_sq": pd.SINGLE_LAUNCHES}
    check(search._surrogate is not None, "the surrogate did not train")
    expect = len(mesh.shards) * 2 * generations + 2
    if device != "cpu":
        check(launches["min_sq_pair"] == expect,
              f"pair kernel launched {launches['min_sq_pair']} times on "
              f"{name}, expected {expect}")
    b1 = bests[1]
    check(all(math.isfinite(b.fitness) for b in bests)
          and b1.delays.shape == (search.cfg.H,), "bad returned table")
    faults = np.asarray(b1.faults, np.float32)
    if search.cfg.ga.max_fault > 0:
        check(faults.min() >= 0.0 and faults.max() <= np.float32(
            search.cfg.ga.max_fault) and faults.any(),
            "fault table outside [0, max_fault] or all zero")
    else:
        check(not faults.any(), "faults returned without a fault half")
    rescored = rescore_on_cpu(search, refs, b1.delays, b1.faults)
    check(math.isclose(rescored, b1.fitness, rel_tol=RTOL, abs_tol=ATOL),
          f"re-scored fitness {rescored} != returned {b1.fitness}")
    print(f"  returned table re-scored on the CPU: {rescored:.6f} "
          f"(returned {b1.fitness:.6f})")
    return launches, search, refs, {"schedules_per_s": rates}


def _step_args(search, refs):
    traces, pairs, archive, failures = search._device_inputs(refs)
    return ((search._seed, traces, pairs, archive, failures, search.cfg.ga,
             search.cfg.weights),
            {"novelty_scale": search.novelty_scale(),
             "coin": search._dev_coin, "mesh": search.mesh,
             "rings": search._rings})


def island_pops(state, mesh, I):
    """Delays ``[I, Pi, H]`` of every local island, on the primary
    device."""
    from namazu_tpu_torch.parallel.islands import local_population

    d = local_population(state.pop, mesh).delays
    return d.view(I, -1, d.shape[-1])


def check_island_contracts(search, refs) -> None:
    """Phase 9's contracts on the search's own state: the marker rides
    the ring into the neighbour's tail and not its elites; fused ==
    stepwise over 5 generations; 2 shards of 4 == 1 shard of 8 after 16
    generations, bit for bit."""
    import torch

    from namazu_tpu_torch.models.ga import Population
    from namazu_tpu_torch.parallel.islands import (
        fused_step,
        island_step,
        local_population,
        ring_plan,
        shard_population,
    )

    args, kw = _step_args(search, refs)
    mesh, st, I = search.mesh, search._state, search.mesh.n_islands
    Pi = search.population // I
    _, kk, _, _ = ring_plan(mesh, search._rings, Pi, search.cfg.ga)[0]
    n_elite = max(1, int(Pi * search.cfg.ga.elite_frac))
    pop = local_population(st.pop, mesh)
    planted = pop.delays.clone()
    planted[:Pi] = MARK
    st0 = st._replace(pop=shard_population(
        Population(planted, pop.faults.clone()), mesh))
    d = island_pops(island_step(st0, *args, **kw)[0], mesh, I)
    check(bool((d[0, :min(kk, n_elite)] == MARK).all()),
          "island 0's elite rows are not its marker rows")
    check(torch.equal(d[1, Pi - kk:], d[0, :kk]),
          f"island 1's tail rows [{Pi - kk}, {Pi}) do not hold island 0's "
          f"leading rows")
    check(not bool((d[1, :n_elite] == MARK).all(-1).any()),
          "a migrant overwrote island 1's elite rows")
    print(f"  marker: island 1's rows [{Pi - kk}, {Pi}) hold island 0's "
          f"leading {kk}; its {n_elite} elite rows hold none")

    a, ha = fused_step(st, 5, *args, **kw)
    b, hb = st, []
    for _ in range(5):
        b, fit = island_step(b, *args, **kw)
        hb.append(fit)
    check(torch.equal(island_pops(a, mesh, I), island_pops(b, mesh, I))
          and torch.equal(ha, torch.stack(hb))
          and torch.equal(a.best_delays, b.best_delays),
          "fused != stepwise over 5 generations")
    two = mesh.reshard(I // 2)
    kw2 = dict(kw, mesh=two)
    s2 = st._replace(pop=shard_population(pop, two))
    one, h1 = fused_step(st, 16, *args, **kw)
    other, h2 = fused_step(s2, 16, *args, **kw2)
    check(len(two.shards) == 2 and torch.equal(
        island_pops(one, mesh, I), island_pops(other, two, I))
          and torch.equal(h1, h2)
          and torch.equal(one.best_delays, other.best_delays),
          "2 shards of 4 != 1 shard of 8 after 16 generations")
    print("  fused == stepwise over 5 generations; 2 shards of "
          f"{I // 2} == 1 shard of {I} after 16 generations, bit for bit")


def profile_islands(search, refs) -> dict:
    """One fused chunk of the island search traced by torch.profiler,
    and its GA (every island's draws included) and one migration of
    every ring timed alone by CUDA events."""
    from namazu_tpu_torch.models.ga import Population, ga_generation
    from namazu_tpu_torch.ops import schedule as sched
    from namazu_tpu_torch.parallel.islands import (
        _migrate,
        fused_step,
        generator_for,
        ring_plan,
    )

    args, kw = _step_args(search, refs)
    mesh, st, cfg = search.mesh, search._state, search.cfg
    I = mesh.n_islands
    Pi = search.population // I
    d, f = st.pop
    fitness, _ = sched.score_population_multi(
        d, args[1], args[2], args[3], args[4], cfg.weights,
        faults=None if search._dev_coin is None else f,
        coin=search._dev_coin)
    view = Population(d.view(I, Pi, -1), f.view(I, Pi, -1))
    plan = ring_plan(mesh, search._rings, Pi, cfg.ga)
    copy = [Population(view.delays.clone(), view.faults.clone())]

    def ga():
        return ga_generation(
            [generator_for(search._seed, st.gen, search.device,
                           mesh.coords(g)) for g in range(I)],
            view, fitness.view(I, Pi), cfg.ga)

    out = {"ga_ms": cuda_time_ms(ga, iters=20),
           "migration_ms": cuda_time_ms(
               lambda: _migrate(copy, mesh, plan, 0), iters=20)}
    chunk = cfg.fused_chunk
    prof = device_profile(lambda: fused_step(st, chunk, *args, **kw), chunk)
    out.update({f"generation_{k}" if k != "device_busy_share" else k: v
                for k, v in prof.items()})
    print(f"  a generation under the profiler: {prof['wall_ms']:.3f} ms "
          f"wall, {prof['device_ms']:.3f} ms device, busy "
          f"{prof['device_busy_share']:.1%}, {prof['launches']:.1f} "
          f"launches ({prof['rng_launches']:.1f} RNG); GA "
          f"{out['ga_ms']:.3f} ms, migration {out['migration_ms']:.4f} ms")
    return out


def check_host_ring_cadence(search, refs, steps: int = 8) -> None:
    """Phase 10: the host ring's migrants land only on generations
    divisible by its cadence (``dcn_migrate_every``)."""
    import torch

    from namazu_tpu_torch.parallel.islands import island_step, ring_plan

    args, kw = _step_args(search, refs)
    mesh, st = search.mesh, search._state
    I, (nh, ni) = mesh.n_islands, mesh.sizes
    Pi = search.population // I
    (_, _, _, _), (h_axis, kk, off, every) = ring_plan(
        mesh, search._rings, Pi, search.cfg.ga)
    check(h_axis == 0 and every > 1, "no host ring with a cadence")
    seen = []
    for _ in range(steps):
        gen = st.gen
        st = island_step(st, *args, **kw)[0]
        d = island_pops(st, mesh, I).view(nh, ni, Pi, -1)
        landed = torch.equal(d[1, :, Pi - off - kk:Pi - off], d[0, :, :kk])
        check(landed == (gen % every == 0),
              f"host ring at generation {gen}: landed={landed}, cadence "
              f"{every}")
        seen.append(gen)
    print(f"  host ring ({kk} rows every {every} generations) landed on "
          f"{[g for g in seen if g % every == 0]} of generations {seen}")


def count_syncs(fn) -> int:
    """Synchronizing CUDA calls ``fn`` makes, as torch's sync debug mode
    flags them."""
    import warnings

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # the mode's own notice on first use is not a sync
    return sum(SYNC_WARNING in str(w.message) for w in caught)


def drive_mcts_trees(device, storage, sp, ip, mesh) -> tuple:
    """Phase 10's MCTS: one search of 8 root-parallel trees in lockstep
    at the policy's MCTS defaults; B1 launches once a simulation for all
    trees, and one sync a simulation."""
    import torch

    from namazu_tpu_torch.models.mcts import mcts_search_trees
    from namazu_tpu_torch.ops import pair_distance as pd
    from namazu_tpu_torch.parallel.islands import fold_coords

    search, refs = island_search(device, storage,
                                 dict(sp, search_backend="mcts"), ip, mesh)
    sims, trees = search.mcts_cfg.simulations, mesh.n_islands
    sync(device)
    pd.LAUNCHES = pd.SINGLE_LAUNCHES = 0
    best = search.run(refs, generations=64)
    launches = {"min_sq_pair": pd.LAUNCHES, "min_sq": pd.SINGLE_LAUNCHES}
    secs = search.last_run_seconds
    print(f"  {trees} trees x {sims} simulations: {secs:.4f} s, "
          f"{sims / secs:.1f} lockstep simulations/s, "
          f"{trees * sims / secs:.1f} tree simulations/s; fitness "
          f"{best.fitness:.6f}")
    if device != "cpu":
        check(launches["min_sq_pair"] == sims,
              f"pair kernel launched {launches['min_sq_pair']} times for "
              f"{trees} trees, expected {sims}")
    rescored = rescore_on_cpu(search, refs, best.delays, best.faults)
    check(math.isclose(rescored, best.fitness, rel_tol=RTOL, abs_tol=ATOL),
          f"re-scored fitness {rescored} != returned {best.fitness}")
    out = {"search_s": secs, "lockstep_simulations_per_s": sims / secs,
           "tree_simulations_per_s": trees * sims / secs}
    if device == "cpu":
        return launches, out
    traces, pairs, archive, failures = search._device_inputs(refs)
    order = search._hint_order(refs)
    seeds = [fold_coords(12345, mesh.coords(g)) for g in range(trees)]

    def run():
        res = mcts_search_trees(seeds, traces, pairs, archive, failures,
                                order, search.cfg.H, search.mcts_cfg,
                                search.cfg.weights, coin=search._dev_coin)
        return res

    syncs = count_syncs(run)
    check(syncs == sims, f"{syncs} syncs for {sims} simulations, expected "
                         f"one a simulation")
    sync(device)
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    prof = device_profile(run, sims)
    out.update({"alone_s": wall, "alone_tree_simulations_per_s":
                trees * sims / wall, "syncs_per_simulation": syncs / sims})
    out.update({f"simulation_{k}" if k != "device_busy_share" else k: v
                for k, v in prof.items()})
    print(f"  one search alone: {wall:.4f} s ({trees * sims / wall:.1f} "
          f"tree simulations/s); {syncs / sims:.2f} syncs a simulation; "
          f"under the profiler a simulation takes {prof['wall_ms']:.3f} ms "
          f"wall, {prof['device_ms']:.3f} ms device, busy "
          f"{prof['device_busy_share']:.1%}, {prof['launches']:.1f} "
          f"launches")
    return launches, out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def drive_process_world(device, storage, sp, ip, generations=16) -> None:
    """Phase 10: a one-process ``torch.distributed`` world (NCCL on the
    card, gloo on the CPU) started by ``initialize_from_env`` from its
    environment; the hybrid search over it goes through the collectives
    (the host ring, the global best, the gathered population) and must
    equal the same mesh without them bit for bit."""
    import torch
    import torch.distributed as dist

    from namazu_tpu_torch.parallel.distributed import (
        initialize_from_env,
        make_hybrid_mesh,
    )
    from namazu_tpu_torch.parallel.mesh import IslandMesh

    env = {"NMZ_TPU_COORDINATOR": f"127.0.0.1:{_free_port()}",
           "NMZ_TPU_NUM_PROCESSES": "1", "NMZ_TPU_PROCESS_ID": "0"}
    os.environ.update(env)
    try:
        check(initialize_from_env(device=device), "no process group")
        print(f"  torch.distributed up: backend {dist.get_backend()}, "
              f"world {dist.get_world_size()}")
        n = HYBRID_HOSTS * (ISLANDS // HYBRID_HOSTS)
        mesh = make_hybrid_mesh(n_hosts=HYBRID_HOSTS, devices=[device] * n)
        check(mesh.distributed, "the mesh does not use the process group")
        plain = IslandMesh(mesh.axis_names, mesh.sizes, [device] * n)
        outs = []
        for m in (mesh, plain):
            search, refs = island_search(device, storage, sp, ip, m)
            best = search.run(refs, generations=generations)
            outs.append((search._fetch_population(), best))
        (pa, ba), (pb, bb) = outs
        check(all((x == y).all() for x, y in zip(pa, pb))
              and ba.fitness == bb.fitness
              and (ba.delays == bb.delays).all(),
              "the search through the collectives differs")
        print(f"  {generations} generations through the collectives equal "
              f"the same mesh without them, bit for bit (fitness "
              f"{ba.fitness:.6f})")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k in env:
            os.environ.pop(k, None)
        sync(device)
    check(not torch.distributed.is_initialized(), "process group left up")


def drive_island_paths(device, delay_storage, fault_storage,
                       generations=GENERATIONS, search_params=None,
                       ingest_params=None):
    """Phases 9-10: the island search with faults (config 4's layout: 8
    islands of 512 on the card, ring of 8 every generation) and in delay
    mode, the 2 x 4 hybrid mesh with the host ring every 4th generation,
    8 root-parallel MCTS trees, and a one-process distributed world.
    Returns ``({path: launches}, {path: numbers})``."""
    from namazu_tpu_torch.parallel.distributed import make_hybrid_mesh
    from namazu_tpu_torch.parallel.mesh import make_island_mesh

    sp0 = dict(search_params or POLICY_SEARCH_PARAMS, migrate_k=8,
               migrate_every=1)
    ip = ingest_params or POLICY_INGEST_PARAMS
    launches, numbers = {}, {}
    for name, storage, extra in (
            ("islands_faults", fault_storage, {"max_fault": 0.1}),
            ("islands_delay", delay_storage, {})):
        print(f"phase: {name}")
        launches[name], search, refs, numbers[name] = drive_island_path(
            name, device, storage, dict(sp0, **extra), ip,
            make_island_mesh(ISLANDS, device=device), generations)
        if name == "islands_faults":
            check_island_contracts(search, refs)
        if device != "cpu":
            numbers[name]["generation"] = profile_islands(search, refs)
        del search, refs
    print("phase: hybrid mesh, root-parallel MCTS, process world")
    n = ISLANDS
    hybrid = make_hybrid_mesh(n_hosts=HYBRID_HOSTS, devices=[device] * n)
    sp_h = dict(sp0, dcn_migrate_every=4)
    launches["hybrid"], search, refs, numbers["hybrid"] = drive_island_path(
        "hybrid", device, delay_storage, sp_h, ip, hybrid, generations)
    check_host_ring_cadence(search, refs)
    if device != "cpu":
        numbers["hybrid"]["generation"] = profile_islands(search, refs)
    del search, refs
    launches["mcts_trees"], numbers["mcts_trees"] = drive_mcts_trees(
        device, fault_storage, sp0, ip, make_island_mesh(n, device=device))
    drive_process_world(device, delay_storage, sp_h, ip)
    return launches, numbers


# -- phase 12: the in-process policy path -----------------------------------

NMZ_RANGES = ("nmz_score", "nmz_mutate", "nmz_migrate", "nmz_select")


def ranges_and_kernels(path, kernel_names=None) -> dict:
    """``{range: [occurrences, CUDA kernels launched inside them]}`` of
    the island step's ranges in one ``torch.profiler`` Chrome trace: a
    kernel is inside a range when the runtime call that launched it (the
    same correlation id) ran on the range's thread within its span. With
    ``kernel_names`` only kernels whose name holds one of them count."""
    import bisect

    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    kernels = {e["args"].get("correlation") for e in events
               if e.get("cat") == "kernel" and (
                   kernel_names is None
                   or any(k in e.get("name", "") for k in kernel_names))}
    launches = {}
    for e in events:
        if (e.get("cat") in ("cuda_runtime", "cuda_driver")
                and e.get("args", {}).get("correlation") in kernels):
            launches.setdefault((e["pid"], e["tid"]), []).append(e["ts"])
    for ts in launches.values():
        ts.sort()
    out = {r: [0, 0] for r in NMZ_RANGES}
    for e in events:
        if e.get("cat") == "user_annotation" and e["name"] in out:
            ts = launches.get((e["pid"], e["tid"]), [])
            out[e["name"]][0] += 1
            out[e["name"]][1] += (bisect.bisect_right(ts, e["ts"] + e["dur"])
                                  - bisect.bisect_left(ts, e["ts"]))
    return out


def recording_sink():
    """A telemetry sink (``namazu_tpu_torch.obs``) that keeps the phases
    entered and the names of the other calls, in order."""
    import contextlib

    from namazu_tpu_torch.obs import Telemetry

    class Sink(Telemetry):
        def __init__(self):
            self.phases, self.calls = [], []

        def search_phase(self, phase):
            self.phases.append(phase)
            return contextlib.nullcontext()

        def search_round(self, *args, **kw):
            self.calls.append("search_round")

        def record_generation(self, *args, **kw):
            self.calls.append("record_generation")

        def scorer_throughput(self, *args, **kw):
            self.calls.append("scorer_throughput")

        def search_progress(self, *args, **kw):
            self.calls.append("search_progress")

        def search_device_trace(self, *args, **kw):
            self.calls.append("search_device_trace")

    return Sink()


def policy_search(device, storage, ckpt, sp, ip, generations, sink):
    """One search of the policy's thread as ``TPUSearchPolicy.
    _search_once`` runs it in-process with the port's search half
    (``namazu_tpu_torch.policy.tpu``, what the ``torch_search`` policy
    calls): the checkpoint's best installed first (numpy alone), the
    search built and resumed from the checkpoint, the history ingested,
    the generations evolved, the result installed and checkpointed.
    The policy's own ``ingest`` and ``install`` phases and its storage
    adapter are the reference's and are not run here. Returns
    ``(installs, search, references, seconds)``."""
    from namazu_tpu_torch.history import load_storage
    from namazu_tpu_torch.models.ingest import ingest_history
    from namazu_tpu_torch.policy import tpu as pol

    t0 = time.perf_counter()
    installs = []
    if os.path.exists(ckpt):
        got = pol.install_from_checkpoint(ckpt, sp["H"])
        if got is not None:
            installs.append(("checkpoint", got[0]))
    search = pol.build_search(sp, device)
    search.telemetry = sink
    if os.path.exists(ckpt):
        search.load(ckpt)
    if search.generations_run > 0 and not installs:
        installs.append(("checkpoint", search.best().delays))
    t1 = time.perf_counter()
    refs = ingest_history(search, load_storage(storage),
                          pol.ingest_params(ip))
    t2 = time.perf_counter()
    best = search.run(refs, generations=generations)
    installs.append(("search", best))
    search.save(ckpt)
    return installs, search, refs, {
        "wall": time.perf_counter() - t0, "ingest": t2 - t1,
        "run": search.last_run_seconds,
        "rerank": search.last_rerank_seconds}


def on_thread(fn, *args):
    """``fn(*args)`` on its own thread, as the policy's search runs;
    its result, or its exception raised here."""
    import threading

    out = {}

    def body():
        try:
            out["value"] = fn(*args)
        except BaseException as e:  # re-raised on the caller's thread
            out["error"] = e

    t = threading.Thread(target=body, name="search")
    t.start()
    t.join(600)
    check(not t.is_alive(), "the policy's search thread did not finish")
    if "error" in out:
        raise out["error"]
    return out["value"]


def drive_policy_path(device, work_dir, storage, generations=GENERATIONS,
                      search_params=None, ingest_params=None):
    """Phase 12: the in-process policy path over ``storage`` (phase 5's
    history) at the policy's defaults, two searches on their own thread,
    the second resuming from the first's checkpoint and installing its
    best first. B1 launches 2 * generations + 2 times; the checkpoint
    holds the reference's keys; the returned table re-scored on the CPU
    gives the returned fitness; the sink sees the phases and calls the
    reference's search makes; the first search's ``device_trace_dir`` capture holds the
    island step's ranges with kernels inside (the ring's only where rows
    move: one island moves none, so one chunk of 8 islands built by the
    policy's build is traced as well); ``dcn_hosts = 2`` on one card is
    refused with the reference's message inside a one-process world.
    Returns ``(launches, numbers)``."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from namazu_tpu_torch.history import load_storage
    from namazu_tpu_torch.models.ingest import ingest_history
    from namazu_tpu_torch.ops import pair_distance as pd
    from namazu_tpu_torch.parallel.mesh import make_island_mesh
    from namazu_tpu_torch.policy import tpu as pol

    os.makedirs(work_dir, exist_ok=True)
    trace_dir = os.path.join(work_dir, "trace")
    sp = search_params or POLICY_SEARCH_PARAMS
    ip = ingest_params or POLICY_INGEST_PARAMS
    ckpt = os.path.join(work_dir, "search.npz")
    sync(device)
    pd.LAUNCHES = pd.SINGLE_LAUNCHES = 0
    numbers, sinks, results = [], [], []
    for r in range(2):
        sink = recording_sink()
        # the first run's config asks for a device trace, the second's not
        spr = dict(sp, device_trace_dir=trace_dir if r == 0 else "")
        installs, search, refs, secs = on_thread(
            policy_search, device, storage, ckpt, spr, ip, generations, sink)
        sinks.append(sink)
        results.append((installs, search, refs))
        numbers.append(secs)
        best = installs[-1][1]
        print(f"  call {r}: wall {secs['wall']:.3f} s, ingest "
              f"{secs['ingest']:.3f} s, run {secs['run']:.4f} s "
              f"({search.population * generations / secs['run']:.1f} "
              f"schedules/s), re-rank {secs['rerank'] * 1e3:.2f} ms; "
              f"installs {[k for k, _ in installs]}; fitness "
              f"{best.fitness:.6f}, generations_run "
              f"{search.generations_run}")
    sync(device)
    launches = {"min_sq_pair": pd.LAUNCHES, "min_sq": pd.SINGLE_LAUNCHES}
    if device != "cpu":
        check(launches["min_sq_pair"] == 2 * generations + 2,
              f"pair kernel launched {launches['min_sq_pair']} times on "
              f"the policy path, expected {2 * generations + 2}")
    (i0, s0, _), (i1, s1, refs) = results
    check([k for k, _ in i0] == ["search"], f"call 0 installed {i0}")
    check([k for k, _ in i1] == ["checkpoint", "search"]
          and np.array_equal(i1[0][1], s0.best().delays),
          "call 1 did not install call 0's checkpointed table first")
    check([s0.generations_run, s1.generations_run]
          == [generations, 2 * generations], "generations_run is wrong")
    check(s1._surrogate is not None, "the surrogate did not train")
    with np.load(ckpt) as z:
        missing = [k for k in CHECKPOINT_KEYS if k not in z.files]
    check(not missing, f"checkpoint lacks {missing}")
    best = i1[-1][1]
    rescored = rescore_on_cpu(s1, refs, best.delays, best.faults)
    check(math.isclose(rescored, best.fitness, rel_tol=RTOL, abs_tol=ATOL),
          f"re-scored fitness {rescored} != returned {best.fitness}")
    print(f"  returned table re-scored on the CPU: {rescored:.6f} "
          f"(returned {best.fitness:.6f})")
    chunks = -(-generations // sp["fused_chunk"])
    for r, (sink, (_, search, _)) in enumerate(zip(sinks, results)):
        phases = (["encode", "evolve"] + ["host_io"] * chunks
                  + ["surrogate"]
                  + ([] if search._surrogate is not None else ["extract"]))
        calls = (["search_progress"] * chunks
                 + (["search_device_trace"] if r == 0 else [])
                 + ["scorer_throughput", "search_round",
                    "record_generation"])
        check(sink.phases == phases, f"call {r} phases {sink.phases}")
        check(sink.calls == calls, f"call {r} telemetry {sink.calls}")
    print(f"  telemetry: phases {sinks[0].phases}, calls "
          f"{sorted(set(sinks[0].calls))}")
    files = os.listdir(os.path.join(trace_dir, "device_trace"))
    check(len(files) == 1, f"{len(files)} device traces, expected 1")
    seen = ranges_and_kernels(os.path.join(trace_dir, "device_trace",
                                           files[0]))
    print(f"  device trace of call 0 (the policy's thread): "
          f"{ {k: tuple(v) for k, v in seen.items()} } "
          f"(occurrences, kernels inside)")
    check(all(seen[r][0] == generations for r in NMZ_RANGES),
          f"ranges missing from the device trace: {seen}")
    if device != "cpu":
        check(all(seen[r][1] > 0 for r in NMZ_RANGES if r != "nmz_migrate"),
              f"a range of the policy thread's capture holds no kernel: "
              f"{seen}")
    # the ring's range where rows move: one chunk of 8 islands
    islands = pol.build_search(sp, device,
                               mesh=make_island_mesh(ISLANDS, device=device))
    refs8 = ingest_history(islands, load_storage(storage),
                           pol.ingest_params(ip))
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device != "cpu":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        islands.run(refs8, generations=sp["fused_chunk"])
        sync(device)
    path8 = os.path.join(work_dir, "islands_trace.json")
    prof.export_chrome_trace(path8)
    seen8 = ranges_and_kernels(path8)
    print(f"  one chunk of {ISLANDS} islands: "
          f"{ {k: tuple(v) for k, v in seen8.items()} }")
    if device != "cpu":
        check(all(v[1] > 0 for v in seen8.values()),
              f"a range of the island capture holds no kernel: {seen8}")
    del islands, refs8
    # dcn_hosts over a one-process world: one card does not split in two
    env = {"NMZ_TPU_COORDINATOR": f"127.0.0.1:{_free_port()}",
           "NMZ_TPU_NUM_PROCESSES": "1", "NMZ_TPU_PROCESS_ID": "0"}
    os.environ.update(env)
    try:
        try:
            pol.build_search(sp, device, dcn_hosts=2)
            refused = None
        except ValueError as e:
            refused = str(e)
        check(dist.is_initialized(), "dcn_hosts started no process group")
        check(refused == "1 devices do not divide into 2 hosts",
              f"dcn_hosts = 2 on one card: {refused!r}")
        print(f"  dcn_hosts = 2 in a one-process {dist.get_backend()} "
              f"world: refused ({refused})")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k in env:
            os.environ.pop(k, None)
    return launches, {"calls": numbers, "device_trace": seen,
                      "islands_trace": seen8}


# -- phase 13: the observed sidecar, a process of its own --------------------

SHIM = "namazu_tpu_torch_sidecar.py"  # the port's nmz-tpu sidecar
# each kernel's name in a trace, demangled or not
KERNEL_NAMES = {"min_sq_pair": ("min_sq_kernel<2>", "min_sq_kernelILi2E"),
                "min_sq": ("min_sq_kernel<1>", "min_sq_kernelILi1E")}
RELAY_INTERVAL_S = 2.0  # the shim's relay pushes every 2 s
SHIM_TURNS = "sppssp"  # warm requests: s the shim, p the package's sidecar
CHILD_READY_S = 240.0  # a child sidecar answers a ping within this
REQUEST_S = 600.0  # a child's request answers within this
SEARCH_PHASES = ("encode", "evolve", "host_io", "surrogate", "extract")


class PushTarget:
    """A framed telemetry push target on the port's wire: each
    ``telemetry`` doc is acknowledged as the reference's aggregator
    acknowledges a fresh one, ``{"ok": true, "last_seq": seq}``, and
    kept with the time it came."""

    def __init__(self):
        import threading

        from namazu_tpu_torch.wire import FramedServer

        self.docs = []
        self._lock = threading.Lock()
        self._srv = FramedServer(self._handle, name="push-target")
        self.port = self._srv.bind_tcp("127.0.0.1", 0)
        self._srv.start()

    def _handle(self, req: dict) -> dict:
        doc = req.get("doc")
        if req.get("op") != "telemetry" or not isinstance(doc, dict):
            return {"ok": False, "error": f"unknown op {req.get('op')!r}"}
        with self._lock:
            self.docs.append((time.monotonic(), doc))
        return {"ok": True, "last_seq": doc.get("seq")}

    def received(self) -> list:
        with self._lock:
            return list(self.docs)

    def shutdown(self) -> None:
        self._srv.shutdown()


def sample(families: list, name: str, stat: str = "count", **labels):
    """The value of ``name{labels}`` in a list of wire families (a
    ``metrics`` answer's or a pushed doc's); of a histogram its ``stat``
    (``count`` or ``sum``); None when absent."""
    for fam in families:
        if fam["name"] != name:
            continue
        for s in fam["samples"]:
            if s["labels"] == labels:
                v = s.get("value", s.get(stat))
                return v[stat] if isinstance(v, dict) else v
    return None


def phase_seconds(addr) -> dict:
    """The seconds each search phase has taken so far in the sidecar at
    ``addr``, read with its ``metrics`` op (which counts no request)."""
    from namazu_tpu_torch import wire

    fams = wire.request(addr, {"op": "metrics"})["metrics"]["metrics"]
    return {p: sample(fams, "nmz_search_phase_seconds", stat="sum",
                      phase=p) or 0.0 for p in SEARCH_PHASES}


def profile_shares(profile: dict, collapsed: str):
    """From the ``profile`` op's two answers: the samples whose stack
    holds ``ingest_history``, of all and of those on a thread serving a
    search (``_search_locked`` on the stack), and the top 5 self-time
    frames of each. Returns ``(numbers, ingest lines of the collapsed
    text)``."""
    stacks = profile["stacks"]

    def count(pred):
        return sum(s["count"] for s in stacks if pred(s["stack"]))

    def holds(frame):
        return lambda st: any(f.endswith(":" + frame) for f in st)

    def top(pred):
        selfs = {}
        for s in stacks:
            if s["stack"] and pred(s["stack"]):
                leaf = s["stack"][-1]
                selfs[leaf] = selfs.get(leaf, 0) + s["count"]
        return sorted(selfs.items(), key=lambda kv: -kv[1])[:5]

    total = count(lambda st: True)
    serving = count(holds("_search_locked"))
    ingest = count(holds("ingest_history"))
    lines = [ln for ln in collapsed.splitlines() if ":ingest_history" in ln]
    return {"samples": total, "serving": serving, "ingest": ingest,
            "ingest_share_of_all": ingest / total if total else 0.0,
            "ingest_share_of_serving": ingest / serving if serving else 0.0,
            "top_self": top(lambda st: True),
            "top_self_serving": top(holds("_search_locked"))}, lines


class Child:
    """A sidecar in a process of its own, started from the repository
    root with its output in ``log_path``; :meth:`start` waits until it
    answers ``ping`` (or fails), :meth:`stop` terminates it."""

    def __init__(self, name: str, argv: list, addr: str, log_path: str):
        self.name, self.argv, self.addr = name, argv, addr
        self.log_path = log_path
        self.proc = None

    def start(self, ready_s: float) -> float:
        """Seconds until the child answered ``ping``."""
        from namazu_tpu_torch import wire

        with open(self.log_path, "w") as log_file:
            self.proc = subprocess.Popen(
                self.argv, cwd=ROOT, stdin=subprocess.DEVNULL,
                stdout=log_file, stderr=log_file)
        t0 = time.perf_counter()
        while True:
            self.check_alive()
            try:
                if wire.request(self.addr, {"op": "ping"}, timeout=5)["ok"]:
                    return time.perf_counter() - t0
            except OSError:
                pass
            check(time.perf_counter() - t0 < ready_s,
                  f"the {self.name} did not answer in {ready_s:.0f} s")
            time.sleep(0.25)

    def check_alive(self) -> None:
        check(self.proc.poll() is None,
              f"the {self.name} exited with {self.proc.returncode}")

    def log_tail(self, n: int = 4000) -> str:
        with open(self.log_path) as f:
            return f.read()[-n:]

    def stop(self) -> None:
        if self.proc is None:
            return
        self.proc.terminate()
        try:
            self.proc.wait(30)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(30)


def timed_request(addr: str, req: dict, timeout: float):
    """``(response, wall seconds)`` of one request on a fresh
    connection; a response other than ``ok`` fails the phase."""
    from namazu_tpu_torch import wire

    t0 = time.perf_counter()
    resp = wire.request(addr, req, timeout=timeout)
    wall = time.perf_counter() - t0
    check(resp.get("ok") is True, f"request to {addr} failed: {resp}")
    return resp, wall


def drive_shim_path(device, work_dir, storage, generations=GENERATIONS,
                    search_params=None, ingest_params=None, walls5=None):
    """Phase 13: ``namazu_tpu_torch_sidecar.py``, the port's ``nmz-tpu
    sidecar``, as a child process on ``device`` with a knowledge pool and
    ``--telemetry-url`` at a push target hosted here, read only over its
    wire: phase 5's request twice on one keep-alive connection over
    ``storage`` (both carry ``device_trace_dir``, so the search stays
    warm; the capture is one-shot), one knowledge ``stats`` op, then the
    ``metrics``, ``fleet`` and ``profile`` ops. Then the plane's cost:
    the package's own sidecar (``python -m namazu_tpu_torch.sidecar``:
    no sink, relay or profiler) as a second child, its first request
    cold and untraced, then warm requests to the two in ``SHIM_TURNS``
    (``s`` the shim, ``p`` the package's): the control for the plane's
    cost. Every check is fatal; the children
    are terminated in any case and their logs printed when a check
    fails. ``walls5``: phase 5's request walls of this call, printed
    beside these. Returns the phase's numbers; its ``traced_launches``
    are the kernels inside the island step's ranges of the child's one
    captured section (request 0's evolve), not of whole requests."""
    import numpy as np

    from namazu_tpu_torch import wire
    from namazu_tpu_torch.policy import tpu as pol

    os.makedirs(work_dir, exist_ok=True)
    sp = dict(search_params or POLICY_SEARCH_PARAMS,
              device_trace_dir=os.path.join(work_dir, "trace"))
    ip = ingest_params or POLICY_INGEST_PARAMS
    ckpt = os.path.join(work_dir, "search.npz")
    port = _free_port()
    addr = f"127.0.0.1:{port}"
    target = PushTarget()
    argv = [sys.executable, os.path.join(ROOT, SHIM), "--listen", addr,
            "--pool-dir", os.path.join(work_dir, "pool"),
            "--telemetry-url", f"tcp://127.0.0.1:{target.port}"]
    if device == "cpu":
        argv += ["--platform", "cpu"]
    children = [Child("shim sidecar", argv, addr,
                      os.path.join(work_dir, "shim.log"))]
    numbers = {}
    try:
        numbers["ready_s"] = children[0].start(CHILD_READY_S)
        print(f"  shim sidecar (pid {children[0].proc.pid}) answering on "
              f"{addr} after {numbers['ready_s']:.2f} s")
        req = {"op": "search", "key": storage, "storage": storage,
               "search_params": sp, "ingest_params": ip,
               "generations": generations, "checkpoint": ckpt}
        resps, walls, split = [], [], []
        before = phase_seconds(addr)
        with socket.create_connection(("127.0.0.1", port),
                                      timeout=REQUEST_S) as sk:
            for r in range(2):
                t1 = time.perf_counter()
                wire.write_frame(sk, req)
                resp = wire.read_frame(sk)
                walls.append(time.perf_counter() - t1)
                check(resp is not None and resp.get("ok") is True,
                      f"shim request {r} failed: {resp}")
                resps.append(resp)
                # each request's phases, and the rest of its wall (the
                # search's build, ingest, checkpoint save, the wire);
                # host_io runs inside evolve
                after = phase_seconds(addr)
                secs = {p: after[p] - before[p] for p in SEARCH_PHASES}
                secs["rest"] = walls[-1] - sum(
                    v for p, v in secs.items() if p != "host_io")
                split.append(secs)
                before = after
            done = time.monotonic()
            wire.write_frame(sk, {"op": "stats"})
            stats = wire.read_frame(sk)
        check(stats is not None and stats.get("ok") is True,
              f"shim stats failed: {stats}")
        numbers["walls"], numbers["split"] = walls, split
        print(f"  requests: walls {walls[0]:.3f} s (traced), "
              f"{walls[1]:.3f} s; phase 5's in this call: {walls5}; "
              f"stats: pool {stats['pool_size']}")
        for r, secs in enumerate(split):
            print(f"  request {r} seconds by phase: "
                  + ", ".join(f"{k} {v:.3f}" for k, v in secs.items()))
        r0, r1 = resps
        check([r0["generations_run"], r1["generations_run"]]
              == [generations, 2 * generations], "generations_run is wrong")
        for r in resps:
            check(len(r["delays"]) == sp["H"] and len(r["faults"]) == sp["H"]
                  and math.isfinite(r["fitness"]), "bad table in a response")
        # the child's search, as its checkpoint left it, on the CPU here
        search = pol.build_search(dict(sp, device_trace_dir=""), "cpu")
        search.load(ckpt)
        refs = newest_references(storage, H=sp["H"])
        rescored = rescore_on_cpu(search, refs, r1["delays"], r1["faults"])
        check(math.isclose(rescored, r1["fitness"], rel_tol=RTOL,
                           abs_tol=ATOL),
              f"re-scored fitness {rescored} != returned {r1['fitness']}")
        with np.load(ckpt) as z:
            missing = [k for k in CHECKPOINT_KEYS if k not in z.files]
        check(not missing, f"checkpoint lacks {missing}")
        print(f"  returned table re-scored on the CPU from the child's "
              f"checkpoint: {rescored:.6f} (returned {r1['fitness']:.6f})")
        # B1 in the child: one launch inside each generation's nmz_score
        tdir = os.path.join(sp["device_trace_dir"], "device_trace")
        files = os.listdir(tdir)
        check(len(files) == 1, f"{len(files)} device traces, expected 1")
        trace = os.path.join(tdir, files[0])
        inside = {k: ranges_and_kernels(trace, names)
                  for k, names in KERNEL_NAMES.items()}
        seen = inside["min_sq_pair"]["nmz_score"]
        numbers["trace_nmz_score"] = seen
        numbers["traced_launches"] = {
            k: sum(n for _, n in r.values()) for k, r in inside.items()}
        print(f"  the child's capture of request 0: nmz_score {seen[0]} "
              f"times, B1 launched {seen[1]} times inside; kernels inside "
              f"the ranges {numbers['traced_launches']}")
        check(seen[0] == generations,
              f"nmz_score {seen[0]} times in the capture, expected "
              f"{generations}")
        if device != "cpu":
            check(seen[1] == generations,
                  f"B1 launched {seen[1]} times inside nmz_score in the "
                  f"child's capture, expected {generations}")
        # the metrics op: requests, generations, phases, throughput
        fams = wire.request(addr, {"op": "metrics"})["metrics"]["metrics"]
        searches = sample(fams, "nmz_sidecar_requests_total", ok="true",
                          op="search")
        stats_n = sample(fams, "nmz_sidecar_requests_total", ok="true",
                         op="stats")
        gens = sample(fams, "nmz_search_generations_total", backend="ga")
        phases = {p: sample(fams, "nmz_search_phase_seconds", phase=p)
                  for p in SEARCH_PHASES}
        rate = sample(fams, "nmz_scorer_schedules_per_sec", source="fused")
        numbers.update(metrics_searches=searches, metrics_stats=stats_n,
                       generations=gens, phases=phases, schedules_per_s=rate)
        print(f"  metrics: search requests {searches}, stats {stats_n}, "
              f"generations {gens}, phase counts {phases}, scorer "
              f"{rate} schedules/s")
        check(searches == 2 and stats_n == 1,
              f"nmz_sidecar_requests_total: search {searches}, stats "
              f"{stats_n}, expected 2 and 1")
        check(gens == 2 * generations,
              f"nmz_search_generations_total {gens}, expected "
              f"{2 * generations}")
        chunks = -(-generations // sp["fused_chunk"])
        # extract runs only when the surrogate does not pick
        check(phases["encode"] == phases["evolve"] == phases["surrogate"]
              == 2 and phases["host_io"] == 2 * chunks
              and (phases["extract"] or 0) <= 2,
              f"nmz_search_phase_seconds counts {phases}")
        check(rate is not None and rate > 0,
              f"nmz_scorer_schedules_per_sec is {rate}")
        fleet = wire.request(addr, {"op": "fleet"})["fleet"]
        jobs = [row["job"] for row in fleet["instances"]]
        check("sidecar" in jobs, f"the fleet has no job sidecar: {jobs}")
        prof = wire.request(addr, {"op": "profile"})["profile"]
        collapsed = wire.request(addr, {"op": "profile",
                                        "format": "collapsed"})["text"]
        check(prof is not None and prof["samples_total"] > 0,
              "the profile op returned no samples")
        shares, lines = profile_shares(prof, collapsed)
        numbers["profile"] = shares
        check(lines, "no collapsed stack holds ingest_history")
        print(f"  fleet jobs {jobs}; profile: {shares['samples']} samples, "
              f"{shares['serving']} serving a search, ingest_history "
              f"{shares['ingest']} ({shares['ingest_share_of_all']:.1%} of "
              f"all, {shares['ingest_share_of_serving']:.1%} of serving)")
        print(f"  top self frames: {shares['top_self']}")
        print(f"  top self frames serving a search: "
              f"{shares['top_self_serving']}")
        # the push target: a doc counting both searches, within 3
        # intervals of the second's answer (a doc carries the series
        # changed since the last acked push, so look at every doc)
        deadline = done + 3 * RELAY_INTERVAL_S
        pushed = None
        while pushed is None:
            for at, doc in target.received():
                if (doc.get("job") == "sidecar"
                        and sample(doc.get("families", []),
                                   "nmz_sidecar_requests_total", ok="true",
                                   op="search") == 2):
                    pushed = at - done
                    check(pushed <= 3 * RELAY_INTERVAL_S,
                          f"the doc counting both searches came "
                          f"{pushed:.2f} s after the second's answer")
                    break
            else:
                check(time.monotonic() < deadline,
                      f"no doc of job sidecar counting both searches came "
                      f"within {3 * RELAY_INTERVAL_S:.0f} s "
                      f"({len(target.received())} docs in all)")
                time.sleep(0.1)
        numbers["push_after_s"] = pushed
        numbers["docs"] = len(target.received())
        print(f"  push target: {numbers['docs']} docs; both searches "
              f"counted in a doc {pushed:.2f} s after the second's answer")
        children[0].check_alive()
        # the plane's cost: the same warm request in turns with the
        # package's own sidecar, also a process of its own
        paddr = f"127.0.0.1:{_free_port()}"
        pargv = [sys.executable, "-m", "namazu_tpu_torch.sidecar",
                 "--listen", paddr]
        if device == "cpu":
            pargv += ["--device", "cpu"]
        children.append(Child("package sidecar", pargv, paddr,
                              os.path.join(work_dir, "package.log")))
        children[1].start(CHILD_READY_S)
        preq = dict(req, checkpoint=os.path.join(work_dir, "package.npz"),
                    search_params=dict(sp, device_trace_dir=""))
        _, cold = timed_request(paddr, preq, REQUEST_S)
        got = {"s": [], "p": []}
        for k in SHIM_TURNS:
            a, r = (addr, req) if k == "s" else (paddr, preq)
            got[k].append(timed_request(a, r, REQUEST_S)[1])
        numbers["turns"] = {"shim": got["s"], "package": got["p"],
                            "package_cold": cold}
        ms, mp = (float(np.median(got[k])) for k in "sp")
        print(f"  warm walls in turns ({SHIM_TURNS}): shim {got['s']}, package "
              f"{got['p']}; medians {ms:.3f} / {mp:.3f} s "
              f"({(ms / mp - 1):+.1%}); the package's cold first request "
              f"(untraced) {cold:.3f} s")
        for c in children:
            c.check_alive()
    except BaseException:
        for c in children:
            if c.proc is not None:
                print(f"  {c.name} log (last 4000 bytes):\n{c.log_tail()}",
                      file=sys.stderr)
        raise
    finally:
        for c in children:
            c.stop()
        target.shutdown()
    return numbers


# -- phase 14: chaos over the campaign's memory ------------------------------

CHAOS_TENANT = "chaos"  # its own shared client, apart from phase 11's


class ScheduledDecider:
    """A fault schedule for the package's chaos seams
    (``namazu_tpu_torch/chaos.py``), written here because this script
    imports nothing of the reference (its ``FaultPlan``). Each point fires
    on the consult indices of its rule, the counterpart of a plan's
    ``at`` rules; :meth:`arm` makes a point fire on its next consult.
    Every fire is logged as ``(point, index)``. It locks itself: the
    sidecar consults it from its connection threads."""

    def __init__(self, at: dict):
        import threading

        self.at = {p: set(ix) for p, ix in at.items()}
        self.consults: dict = {}
        self.fires: list = []
        self._lock = threading.Lock()

    def arm(self, point: str) -> None:
        with self._lock:
            self.at.setdefault(point, set()).add(self.consults.get(point, 0))

    def fired(self, point: str) -> int:
        with self._lock:
            return sum(1 for p, _ in self.fires if p == point)

    def __call__(self, point: str):
        with self._lock:
            index = self.consults.get(point, 0)
            self.consults[point] = index + 1
            if index not in self.at.get(point, ()):
                return None
            self.fires.append((point, index))
        return {"point": point, "index": index}


def drive_chaos_path(device, work_dir, history, generations=GENERATIONS,
                     search_params=None, ingest_params=None):
    """Phase 11's campaign A under injected faults: a port sidecar hosting
    its knowledge service over a fresh pool, campaign A's two requests
    over ``history`` (no device trace) at the policy's defaults with its
    knowledge at the sidecar itself, and after each request the answer's
    table pushed as the policy pushes its best. A decider fires
    ``knowledge.eof`` on the first push's and the first pull's first
    attempts (each retried), ``storage.tear`` on the service's first state
    write and ``storage.fsync`` on its second, and ``knowledge.outage``
    on request 2's first knowledge op (its cooldown silences the rest of
    that request and the push after it). Fixed indices, not draws: an eof
    on a push whose service write runs after its answer would race that
    write against the next op's for the storage consults. Every request
    answers ok with a table that re-scores on the CPU to its fitness;
    B1 launches as on phase 11's path; the client's counts agree with the
    fire log. Then the decider is cleared, the sidecar restarts on the
    same port and pool, and a fresh client's pull returns the highest
    acknowledged fitness; the pool has no temp file and no unreadable
    entry, and the service's state directory holds the one torn temp.
    Returns ``(launches, numbers)``."""
    from namazu_tpu_torch import chaos, wire
    from namazu_tpu_torch.knowledge import (
        KnowledgeClient,
        KnowledgeService,
        shared_client,
    )
    from namazu_tpu_torch.models.failure_pool import pool_fsck
    from namazu_tpu_torch.ops import pair_distance as pd
    from namazu_tpu_torch.sidecar import SidecarServer

    os.makedirs(work_dir, exist_ok=True)
    pool = os.path.join(work_dir, "knowledge-pool")
    sp = dict(search_params or POLICY_SEARCH_PARAMS, guidance=True)
    ip = dict(ingest_params or POLICY_INGEST_PARAMS, guidance=True,
              failure_pool=os.path.join(work_dir, "pool-a"),
              knowledge_tenant=CHAOS_TENANT,
              knowledge_scenario=KNOWLEDGE_SCENARIO)
    decider = ScheduledDecider({"knowledge.eof": [0, 2],
                                "storage.tear": [0], "storage.fsync": [0]})
    server = SidecarServer("127.0.0.1", 0, device=device,
                           knowledge=KnowledgeService(pool, device=device))
    server.start()
    port = server.port
    addr = f"127.0.0.1:{port}"
    ip["knowledge"] = addr
    ckpt = os.path.join(work_dir, "search-a.npz")
    req = {"op": "search", "key": history, "storage": history,
           "search_params": sp, "ingest_params": ip,
           "generations": generations, "checkpoint": ckpt}
    client = shared_client(addr, tenant=CHAOS_TENANT,
                           scenario=KNOWLEDGE_SCENARIO)
    numbers = {"requests": []}
    acked = []
    chaos.set_decider(decider)
    try:
        sync(device)
        pd.LAUNCHES = pd.SINGLE_LAUNCHES = 0
        with socket.create_connection(("127.0.0.1", port)) as sk:
            for r in range(2):
                if r == 1:
                    decider.arm("knowledge.outage")
                t0 = time.perf_counter()
                wire.write_frame(sk, req)
                resp = wire.read_frame(sk)
                wall = time.perf_counter() - t0
                check(resp is not None and resp.get("ok") is True,
                      f"chaos request {r} failed: {resp}")
                search = server.service.search_for(history)
                refs = newest_references(history, H=search.cfg.H)
                rescored = rescore_on_cpu(search, refs, resp["delays"],
                                          resp["faults"])
                check(math.isclose(rescored, resp["fitness"], rel_tol=RTOL,
                                   abs_tol=ATOL),
                      f"chaos request {r}: re-scored fitness {rescored} "
                      f"!= returned {resp['fitness']}")
                tm = dict(server.service.timings[history])
                # the policy's end-of-run push of its best table
                pushed = client.push(best={
                    "delays": [float(x) for x in resp["delays"]],
                    "fitness": float(resp["fitness"]), "H": search.cfg.H})
                if pushed is not None:
                    acked.append(float(resp["fitness"]))
                numbers["requests"].append(dict(tm, wall=wall))
                print(f"  chaos request {r}: wall {wall:.3f} s; ingest "
                      f"{tm['ingest']:.3f} s (knowledge "
                      f"{tm.get('ingest_knowledge', 0.0):.3f}); run "
                      f"{tm['run']:.4f} s; fitness {resp['fitness']:.6f} "
                      f"(re-scored on the CPU {rescored:.6f}); best push "
                      f"{'acknowledged' if pushed else 'degraded'}; fires "
                      f"so far {decider.fires}")
        launches = {"min_sq_pair": pd.LAUNCHES, "min_sq": pd.SINGLE_LAUNCHES}
    finally:
        chaos.clear_decider()
        server.shutdown()
    counts = dict(client.counts)
    print(f"  knowledge client counts {counts}; consults "
          f"{decider.consults}; fires {decider.fires}")
    if device != "cpu":
        check(launches["min_sq_pair"] == 2 * generations + 2,
              f"pair kernel launched {launches['min_sq_pair']} times on the "
              f"chaos path, expected {2 * generations + 2}")
    for point in ("knowledge.eof", "knowledge.outage", "storage.tear",
                  "storage.fsync"):
        check(decider.fired(point) >= 1, f"{point} never fired")
    check(decider.fired("knowledge.outage") == 1, "more than one outage")
    # each eof hit a first attempt and was retried, with no outage of its
    # own; the one outage silenced the client for its cooldown: no op
    # reached the wire after it
    check(counts.get("retries", 0) == decider.fired("knowledge.eof"),
          f"retries {counts.get('retries')} != eof fires")
    check(counts.get("outages", 0) == 1, f"outages {counts.get('outages')}")
    check(counts.get("requests", 0)
          == counts.get("answered", 0) + counts.get("outages", 0),
          f"requests not all answered but the outage: {counts}")
    check(decider.consults["knowledge.outage"] == counts["requests"],
          "an op consulted the outage point outside the counted requests")
    last = max(i for p, i in decider.fires if p == "knowledge.outage")
    check(last == decider.consults["knowledge.outage"] - 1,
          "an op reached the wire after the outage, inside its cooldown")
    check(not client.available(), "the outage's cooldown is not open")
    check(acked, "no best table was acknowledged")
    # the restart: a fresh service over the same pool on the same port
    server = SidecarServer("127.0.0.1", port, device=device,
                           knowledge=KnowledgeService(pool, device=device))
    server.start()
    try:
        fresh = KnowledgeClient(addr, tenant=CHAOS_TENANT,
                                scenario=KNOWLEDGE_SCENARIO)
        pulled = fresh.pull(search.cfg.H)
        fresh.close()
    finally:
        server.shutdown()
    check(pulled is not None and pulled[1] is not None,
          f"the restarted service has no table: {pulled}")
    check(pulled[1]["fitness"] == max(acked),
          f"pulled fitness {pulled[1]['fitness']} != highest acknowledged "
          f"{max(acked)}")
    report = pool_fsck(pool)
    check(not report["unreadable_entries"] and not report["tmp_artifacts"],
          f"pool fsck: {report}")
    state = os.path.join(pool, "_state")
    torn = sorted(n for n in os.listdir(state) if n.endswith(".tmp"))
    check(len(torn) == decider.fired("storage.tear"),
          f"state temps {torn} after {decider.fired('storage.tear')} tears")
    print(f"  restarted on port {port}: pulled fitness "
          f"{pulled[1]['fitness']:.6f} (acknowledged {acked}); pool fsck "
          f"{report['entries']} entries, no temp, none unreadable; torn "
          f"temps in the state directory {torn}")
    numbers.update(counts=counts, fires=decider.fires, acked=acked,
                   torn=torn)
    return launches, numbers


# -- phase 15: the driver entry ----------------------------------------------


def drive_entry_path(device):
    """``namazu_tpu_torch.entry`` on ``device``: the scorer once (B1 once on
    the card), held to the same fn on the CPU (the plain versions) on the
    same inputs; ``dryrun_multichip(8)`` and ``dryrun_multichip_fused(16)``
    (B1 once a shard and generation). Returns ``({path: launches},
    numbers)``."""
    import torch

    from namazu_tpu_torch import entry
    from namazu_tpu_torch.ops import pair_distance as pd

    launches, numbers = {}, {}

    def counted(name, fn, *args, **kw):
        sync(device)
        pd.LAUNCHES = pd.SINGLE_LAUNCHES = 0
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        sync(device)
        numbers[f"{name}_s"] = time.perf_counter() - t0
        launches[name] = {"min_sq_pair": pd.LAUNCHES,
                          "min_sq": pd.SINGLE_LAUNCHES}
        return out

    fn, args = entry.entry(device)
    got = counted("entry", fn, *args).cpu()
    cfn, cargs = entry.entry("cpu")
    check(all(torch.equal(a.cpu(), b) for a, b in zip(args, cargs)),
          "entry's inputs differ between the card and the CPU")
    want = cfn(*cargs)
    err = float((got.double() - want.double()).abs().max())
    check(torch.allclose(got, want, rtol=RTOL, atol=ATOL),
          f"entry on {device} differs from the CPU by {err}")
    print(f"  entry: fitness [{got.shape[0]}] within rtol {RTOL} / atol "
          f"{ATOL} of the CPU's (max abs err {err:.3g}), "
          f"{numbers['entry_s'] * 1e3:.2f} ms with its first launch")
    numbers["entry_max_abs_err"] = err
    counted("dryrun_multichip", entry.dryrun_multichip, 8, device=device)
    fused = counted("dryrun_multichip_fused", entry.dryrun_multichip_fused,
                    16, device=device)
    check(fused["ok"] is True, f"fused dry run: {fused}")
    numbers["dryrun_multichip_fused"] = fused
    print(f"  dryrun_multichip_fused: overhead factor "
          f"{fused['overhead_factor']} (mesh {fused['t_mesh_s']} s, one "
          f"island {fused['t_single_device_s']} s)")
    if device != "cpu":
        shards = len(set(entry.island_devices(8, device)))
        want_launches = {"entry": 1, "dryrun_multichip": 2 * shards,
                         # 4 dispatches of 8 generations, mesh then one island
                         "dryrun_multichip_fused": 32 * (
                             len(set(entry.island_devices(16, device))) + 1)}
        for name, n in want_launches.items():
            check(launches[name]["min_sq_pair"] == n,
                  f"pair kernel launched {launches[name]['min_sq_pair']} "
                  f"times on {name}, expected {n}")
    print(f"  B1 launches: {launches}")
    return launches, numbers


# -- phase 16: the port's bench -----------------------------------------------


def drive_bench_path(device, sizes=None):
    """``namazu_tpu_torch/bench.py``'s scorer and fused benches on
    ``device`` in this process at ``sizes`` (the bench's production sizes
    by default), their records published into a temporary history. Each
    returns its platform, the card and a positive rate; on the card B1
    launches once for the accuracy check and once a pass of the warm-up
    and timed chains (scorer), once a generation of the warm-up and timed
    fused runs, the warm step and the timed unfused runs (fused); one
    scoring chain read back makes one sync, the read. Then, on the card,
    device ms a pass and a generation (CUDA events) and launches a pass
    and a generation (torch.profiler). Returns ``({path: launches},
    numbers)``."""
    import tempfile

    import torch

    from namazu_tpu_torch import bench
    from namazu_tpu_torch.ops import pair_distance as pd
    from namazu_tpu_torch.parallel.islands import (
        fused_step,
        init_island_state,
        one_island,
    )

    sizes = sizes or bench.PRODUCTION
    n, reps = sizes.iters, sizes.reps
    launches, numbers = {}, {}
    card = card_line() if device != "cpu" else None
    with tempfile.TemporaryDirectory() as tmp:
        history = os.path.join(tmp, "history.jsonl")
        for name, run in (("bench_scorer", bench.run_scorer_bench),
                          ("bench_fused", bench.run_fused_bench)):
            sync(device)
            pd.LAUNCHES = pd.SINGLE_LAUNCHES = 0
            out = run(device, sizes)
            sync(device)
            launches[name] = {"min_sq_pair": pd.LAUNCHES,
                              "min_sq": pd.SINGLE_LAUNCHES}
            check(out["platform"] == torch.device(device).type
                  and out["card"] == card and out["value"] > 0,
                  f"{name}: {out}")
            check(bench.publish(dict(out), history) == 0,
                  f"{name}: publishing failed")
            numbers[name] = out
        records = bench.load_history(history)
        kept = sum(not out.get("smoke") for out in numbers.values())
        check([r["platform"] for r in records] == [
            torch.device(device).type] * kept, f"history records {records}")
    scorer, fused = numbers["bench_scorer"], numbers["bench_fused"]
    print(f"  scorer: {scorer['value']} schedules/s, vs_baseline "
          f"{scorer['vs_baseline']}, fitness within rtol {bench.RTOL} / "
          f"atol {bench.ATOL} of the CPU's (max abs err "
          f"{scorer['check_max_abs_err']:.3g}); fused: {fused['value']} "
          f"schedules/s, unfused {fused['unfused_schedules_per_sec']}, "
          f"vs_unfused {fused['vs_unfused']}; card {card}")
    if device != "cpu":
        want = {"bench_scorer": 1 + (reps + 1) * n,
                "bench_fused": (reps + 1) * n + 1 + reps * n}
        for name, w in want.items():
            check(launches[name]["min_sq_pair"] == w,
                  f"pair kernel launched {launches[name]['min_sq_pair']} "
                  f"times on {name}, expected {w}")
        inputs = bench.bench_inputs(*sizes[:6], device)
        d = inputs.pop.delays

        def chain():
            return bench.score_chain(d, inputs, n)

        syncs = count_syncs(lambda: chain()[0, 0].item())
        check(syncs == 1, f"one scoring chain read back made {syncs} "
                          "syncs, expected 1 (the read)")
        numbers["chain_syncs"] = syncs
        mesh = one_island(device)
        state = init_island_state(0, sizes.P, sizes.H, bench.GA, mesh=mesh)

        def generations():
            fused_step(state, n, bench.FUSED_SEED, inputs.trace,
                       inputs.pairs, inputs.archive, inputs.failures,
                       bench.GA, mesh=mesh, rings=bench.RINGS)

        for what, fn in (("pass", chain), ("generation", generations)):
            numbers[f"event_ms_per_{what}"] = cuda_time_ms(
                fn, iters=3, warmup=1) / n
            numbers[f"profile_per_{what}"] = device_profile(fn, n)
            prof = numbers[f"profile_per_{what}"]
            print(f"  a {what}: {numbers[f'event_ms_per_{what}']:.4f} ms "
                  f"between CUDA events, {prof['device_ms']:.4f} ms of "
                  f"kernels, {prof['launches']:.1f} launches, busy "
                  f"{prof['device_busy_share']:.1%}")
    print(f"  B1 launches: {launches}")
    return launches, numbers


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="build and check the kernels (phases 1-2, "
                         "untimed), then stop without the result line")
    args = ap.parse_args(argv)
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
        counts = sass_counts(_build.lib_path(name))
        for fn, c in sorted(counts.items()):
            print(f"  sass {name} {fn}: {c}")
        for op in ("HGMMA", "UTMALDG"):
            total = sum(c[op] for c in counts.values())
            print(f"  sass {name}: {total} {op} instructions")
            check(total > 0, f"{name}: no {op} instruction in its SASS")

    print("phase: kernels against their plain versions")
    built_search = build_search("cuda")
    real = real_feature_rows(*built_search)
    timed = not args.kernels_only
    pair = check_pair_kernel("cuda", real, timed)
    single = check_single_kernel("cuda", real, timed)
    del real
    if args.kernels_only:
        return 0

    print("phase: fused search")
    from namazu_tpu_torch.ops import pair_distance as pd

    fused_launches, search, refs = drive_main_path("cuda",
                                                   built=built_search)
    del built_search
    fused = {"min_sq_pair": fused_launches, "min_sq": pd.SINGLE_LAUNCHES}
    torch.cuda.synchronize()

    print("phase: where a generation's time goes")
    breakdown = profile_generation(search, refs)
    print(json.dumps({"breakdown": breakdown}))
    del search, refs
    torch.cuda.synchronize()

    print("phase: sidecar path")
    work = os.path.join(ROOT, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        walls5 = []
        sidecar = drive_sidecar_path("cuda", work, walls=walls5)
        torch.cuda.synchronize()
        print("phase: fault, order and MCTS paths (one history)")
        extra, numbers = drive_extra_paths("cuda", work)
        torch.cuda.synchronize()
        print(json.dumps({"paths": numbers}))
        islands, numbers = drive_island_paths(
            "cuda", os.path.join(work, "history"),
            os.path.join(work, "history-mixed"))
        extra.update(islands)
        print(json.dumps({"island_paths": numbers}))
        print("phase: knowledge and guidance path")
        knowledge, numbers = drive_knowledge_path(
            "cuda", os.path.join(work, "knowledge"),
            history_a=os.path.join(work, "history"))
        extra.update(knowledge)
        walls11 = [round(n["wall"], 3) for n in numbers["knowledge_a"]]
        torch.cuda.synchronize()
        print(json.dumps({"knowledge_path": numbers}))
        print("phase: in-process policy path")
        extra["policy"], numbers = drive_policy_path(
            "cuda", os.path.join(work, "policy"),
            os.path.join(work, "history"))
        torch.cuda.synchronize()
        print(json.dumps({"policy_path": numbers}))
        print("phase: the observed sidecar (namazu_tpu_torch_sidecar.py)")
        shim = drive_shim_path("cuda", os.path.join(work, "shim"),
                               os.path.join(work, "history"),
                               walls5=[round(w, 3) for w in walls5])
        print(json.dumps({"shim_path": shim}))
        print("phase: chaos over the campaign's memory")
        t0 = time.perf_counter()
        extra["chaos"], numbers = drive_chaos_path(
            "cuda", os.path.join(work, "chaos"),
            os.path.join(work, "history"))
        numbers["phase_s"] = time.perf_counter() - t0
        walls14 = [round(n["wall"], 3) for n in numbers["requests"]]
        print(f"  request walls {walls14} s; phase 11's campaign A in this "
              f"call: {walls11} s; the phase {numbers['phase_s']:.2f} s")
        print(json.dumps({"chaos_path": numbers}))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.synchronize()
    print("phase: the driver entry")
    t0 = time.perf_counter()
    entries, numbers = drive_entry_path("cuda")
    numbers["phase_s"] = time.perf_counter() - t0
    print(f"  the phase {numbers['phase_s']:.2f} s")
    extra.update(entries)
    print(json.dumps({"entry_path": numbers}))
    torch.cuda.synchronize()
    print("phase: the port's bench")
    t0 = time.perf_counter()
    benches, numbers = drive_bench_path("cuda")
    numbers["phase_s"] = time.perf_counter() - t0
    print(f"  the phase {numbers['phase_s']:.2f} s")
    extra.update(benches)
    print(json.dumps({"bench_path": numbers}))
    for k in (pair, single):
        k["launches"] = sidecar[k["name"]]
        k["launches_by_path"] = dict(
            {"fused_search": fused[k["name"]], "sidecar": sidecar[k["name"]]},
            **{path: n[k["name"]] for path, n in extra.items()})
        # in the shim's own process: kernels in its capture of request 0
        k["launches_by_path"]["shim_sidecar_traced"] = \
            shim["traced_launches"][k["name"]]
    print(card)
    print(json.dumps({"kernels": [pair, single]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
