"""ScheduleSearch: the host-side controller of the island GA, ported from
``namazu_tpu/models/search.py`` (``SearchBase`` + ``ScheduleSearch``).

Owns the precedence pairs and the novelty/failure archives (host ring
buffers with device copies written in place), keeps the reference traces
on the device keyed by content, runs generations over a mesh of islands
(``parallel/mesh.py``; one island on one card by default; on a CUDA
device with the mesh in one shard, each chunk of the fused loop replays
as a captured CUDA graph, ``parallel/graphs.py``), and extracts
the delay table for the control plane to replay: the best seen,
or, with ``surrogate_topk > 0`` once the surrogate has enough labeled
runs of both outcomes, the surrogate's pick among the evolved
population's top-k by fitness.

History ingest (``models/ingest.py``) refits the precedence pairs to the
occupied hint buckets (``set_occupied_buckets``), seeds the population
with failures' delay tables (``seed_population``) and fills the archives.

Checkpoints keep the reference's ``.npz`` keys, ``key`` included (the
uint32[2] that ``jax.random.PRNGKey(seed)`` holds) and the surrogate's
weights as the reference's flat ``surrogate_params``, so a checkpoint
written by either package loads into the other.

``ScheduleSearch`` scores the fault half of the genome when
``cfg.ga.max_fault > 0`` (with the per-bucket coin the policy replays
with) and order mode when ``cfg.weights.order_mode``. ``MCTSSearch`` is
the MCTS backend (``models/mcts.py``) behind the same driver API.

Causality guidance (``enable_guidance``) wires a relation-coverage map
(``guidance/``): each archive slot gains a DAG-shape fragment, so the
surrogate's features widen to ``[K | GUIDANCE_DIMS]``; the GA's delay
mutation is biased toward buckets of one-sided relations; and the final
pick adds ``guidance_bonus`` times each candidate's predicted coverage
gain. ``remote_surrogate`` (the knowledge service's shared model) scores
the candidates while the local surrogate is too thin to train. With
``device_trace_dir`` set, the first fused evolve section is captured by
``torch.profiler`` into ``<dir>/device_trace``.

A search reports to ``telemetry`` (``obs.py``; records nothing by
default) where the reference search reports to its obs plane: the
phases ``encode``, ``evolve`` (with the fused loop's ``host_io`` lane
inside), ``surrogate`` and, when no candidate is picked, ``extract``,
each also a ``nmz:<phase>`` profiler range; one round record a
``run()``; the fused loop's throughput and best-so-far progress; each
device-trace capture.
"""

from __future__ import annotations

import contextlib
import functools
import hashlib
import logging
import os
import time
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from namazu_tpu_torch import convert
from namazu_tpu_torch.device import DeviceLike
from namazu_tpu_torch.guidance import (
    DEFAULT_WIDTH,
    DEFAULT_WINDOW,
    GUIDANCE_DIMS,
    CoverageMap,
    dag_shape_features,
)
from namazu_tpu_torch.models.failure_pool import trace_digest
from namazu_tpu_torch.models.ga import GAConfig, Population
from namazu_tpu_torch.models.mcts import MCTSConfig, parallel_mcts
from namazu_tpu_torch.models.surrogate import RewardSurrogate
from namazu_tpu_torch.obs import NULL, search_phase
from namazu_tpu_torch.ops import trace_encoding as te
from namazu_tpu_torch.ops.schedule import (
    ScoreWeights,
    TraceArrays,
    score_population_multi,
    trace_features,
)
from namazu_tpu_torch.parallel.distributed import hier_rings
from namazu_tpu_torch.parallel.graphs import (
    ChunkGraphs,
    eligible,
    start_profiler,
    stop_profiler,
)
from namazu_tpu_torch.parallel.islands import (
    fused_step,
    generation_seed,
    init_island_state,
    island_step,
    local_population,
    shard_population,
)
from namazu_tpu_torch.parallel.mesh import IslandMesh, make_mesh

log = logging.getLogger("namazu_tpu_torch.search")


class SearchConfig(NamedTuple):
    H: int = te.DEFAULT_H  # hint buckets (genome length)
    L: int = te.DEFAULT_L  # encode-length cap hint (informational)
    K: int = te.DEFAULT_K  # feature pairs
    archive_size: int = 512  # novelty archive capacity
    failure_size: int = 64  # failure archive capacity
    population: int = 4096  # genomes over every island
    migrate_k: int = 8  # genomes a ring migration moves
    seed: int = 0
    ga: GAConfig = GAConfig()
    weights: ScoreWeights = ScoreWeights()
    # > 0: the surrogate re-ranks the evolved population's top-k by
    # fitness and run() returns its pick (once it has trained)
    surrogate_topk: int = 0
    # novelty anneal: with at least this many distinct failure signatures
    # the novelty weight is scaled by min_failure_signatures / n (never
    # below novelty_floor); 0 disables
    min_failure_signatures: int = 0
    novelty_floor: float = 0.25
    # with a guidance map wired: weight of a candidate's predicted
    # relation-coverage gain in the final pick
    guidance_bonus: float = 0.5
    # run the generations in chunks of fused_chunk per call with no host
    # sync inside a chunk; False = one call per generation. Both give the
    # same populations bit for bit.
    fused: bool = True
    fused_chunk: int = 16
    migrate_every: int = 1
    dcn_migrate_every: int = 1
    # non-empty: the first fused evolve section of this search is traced
    # by torch.profiler into <device_trace_dir>/device_trace (once)
    device_trace_dir: str = ""


class BestSchedule(NamedTuple):
    delays: np.ndarray  # f32[H] seconds per hint bucket
    faults: np.ndarray  # f32[H] fault probability per hint bucket
    fitness: float


def make_score_weights(
    release_mode: str = "delay",
    w_novelty: float = 1.0,
    w_bug: float = 1.0,
    w_delay_cost: float = 0.01,
    w_fault_cost: float = 0.05,
    tau: float = 0.005,
    reorder_gap: float = 0.002,
    reorder_window: float = 0.05,
) -> ScoreWeights:
    """ScoreWeights for a release mode: order mode permutes within
    reorder_window batches by the table's priorities (delay cost 0, tau
    of the order of the gap); delay mode adds the table to arrivals."""
    if release_mode == "reorder":
        gap = max(reorder_gap, 1e-4)
        return ScoreWeights(
            novelty=w_novelty, bug=w_bug, fault_cost=w_fault_cost,
            order_mode=True, order_gap=gap,
            order_window=max(reorder_window, 0.0),
            tau=gap * 0.5, delay_cost=0.0,
        )
    return ScoreWeights(
        novelty=w_novelty, bug=w_bug, delay_cost=w_delay_cost,
        fault_cost=w_fault_cost, tau=tau,
    )


def key_data(seed: int) -> np.ndarray:
    """The uint32[2] that ``jax.random.PRNGKey(seed)`` holds."""
    s = int(seed) & ((1 << 64) - 1)
    return np.array([s >> 32, s & 0xFFFFFFFF], np.uint32)


def seed_of_key(key: np.ndarray) -> int:
    k = np.asarray(key, np.uint32).reshape(-1)
    return (int(k[0]) << 32) | int(k[1])


class _ResidentTraces:
    """Reference-trace rows kept on the device for the search's lifetime.

    Each distinct trace (content-keyed) is uploaded once into a row of a
    fixed device buffer; a run's ordered ``[T, Lmax]`` view is a row
    gather plus a column slice, value-identical to ``te.stack_traces`` of
    the same references. Rows whose trace left the reference window are
    evicted oldest-first when the buffer is full; a trace longer than the
    rows forces a rebuild."""

    NAMES = ("hint", "arr", "mask", "flt")

    def __init__(self, device: torch.device, capacity: int = 16):
        self.device = device
        self.capacity = capacity
        self.slots: dict = {}  # digest -> row index
        self.order: List[str] = []  # digests, oldest first
        self.bufs: Optional[dict] = None  # name -> device tensor [N, L]
        self.L = 0
        self.appends = 0
        self.rebuilds = 0

    @staticmethod
    def key_of(enc: te.EncodedTrace) -> str:
        h = hashlib.blake2b(digest_size=16)
        h.update(enc.hint_ids.tobytes())
        h.update(enc.arrival.tobytes())
        h.update(enc.mask.tobytes())
        h.update(enc.faultable.tobytes())
        return h.hexdigest()

    def _rows(self, enc: te.EncodedTrace) -> dict:
        rows = te.pad_trace_row(enc, self.L)
        return {"hint": torch.from_numpy(rows["hint"].astype(np.int64)),
                "arr": torch.from_numpy(rows["arr"]),
                "mask": torch.from_numpy(rows["mask"]),
                "flt": torch.from_numpy(rows["flt"])}

    def _rebuild(self, encs, keys, Lmax: int) -> None:
        self.capacity = max(self.capacity, len(encs))
        self.L = max(self.L, Lmax)
        host = {
            "hint": torch.zeros((self.capacity, self.L), dtype=torch.int64),
            "arr": torch.zeros((self.capacity, self.L), dtype=torch.float32),
            "mask": torch.zeros((self.capacity, self.L), dtype=torch.bool),
            "flt": torch.zeros((self.capacity, self.L), dtype=torch.bool),
        }
        self.slots, self.order = {}, []
        for k, e in zip(keys, encs):
            if k in self.slots:
                continue
            slot = len(self.slots)
            for name, row in self._rows(e).items():
                host[name][slot] = row
            self.slots[k] = slot
            self.order.append(k)
        self.bufs = {n: a.to(self.device) for n, a in host.items()}
        self.rebuilds += 1

    def _append(self, key: str, enc: te.EncodedTrace, live) -> None:
        if len(self.slots) < self.capacity:
            slot = len(self.slots)
        else:
            victim = next(k for k in self.order if k not in live)
            slot = self.slots.pop(victim)
            self.order.remove(victim)
        for name, row in self._rows(enc).items():
            self.bufs[name][slot].copy_(row)
        self.slots[key] = slot
        self.order.append(key)
        self.appends += 1

    def view(self, encs, faultable: bool = False) -> TraceArrays:
        """The ``[T, Lmax]`` arrays of ``encs``; the faultable row only
        with ``faultable`` (it is read only when faults are scored)."""
        keys = [self.key_of(e) for e in encs]
        Lmax = max(e.hint_ids.shape[0] for e in encs)
        live = set(keys)
        if (self.bufs is None or Lmax > self.L
                or len(live) > self.capacity):
            self._rebuild(encs, keys, Lmax)
        else:
            for k, e in zip(keys, encs):
                if k not in self.slots:
                    self._append(k, e, live)
        idx = torch.tensor([self.slots[k] for k in keys], device=self.device)
        names = self.NAMES if faultable else self.NAMES[:3]
        return TraceArrays(*(self.bufs[n].index_select(0, idx)[:, :Lmax]
                             .contiguous() for n in names))


def _mesh_for(mesh: Optional[IslandMesh], n_devices: Optional[int],
              device: DeviceLike) -> IslandMesh:
    """The search's mesh: ``mesh``, else ``n_devices`` islands by
    :func:`make_mesh` on ``device`` (one island by default)."""
    if mesh is not None:
        return mesh
    return make_mesh(1 if n_devices is None else n_devices, device=device)


class SearchBase:
    """What every search backend shares: the precedence pairs, the
    novelty/failure archives (host rings with device copies written in
    place), the fault coin, the device-resident reference traces and the
    backend-tagged ``.npz`` checkpoint. ``device`` defaults to
    ``"cuda"``; without a card, pass ``device="cpu"`` (the scorer then
    takes the pair-distance kernel's plain version). The archives and
    traces live on the mesh's primary device."""

    BACKEND = "base"

    def __init__(self, cfg: SearchConfig, mesh: IslandMesh):
        self.mesh = mesh
        self.device = mesh.device
        self.cfg = cfg
        self.pairs = te.sample_pairs(cfg.K, cfg.H, cfg.seed)
        # neutral (0.5) features = "no information"; rings overwrite oldest
        self.archive = np.full((cfg.archive_size, cfg.K), 0.5, np.float32)
        self.archive_labels = np.zeros((cfg.archive_size,), np.float32)
        self._archive_n = 0
        self.failures = np.full((cfg.failure_size, cfg.K), 0.5, np.float32)
        self._failure_n = 0
        # slot-aligned failure digests: re-ingesting a known signature
        # never spends a ring slot
        self._failure_digests = [""] * cfg.failure_size
        self._failure_digest_set: set = set()
        self.generations_run = 0
        self.last_run_seconds = 0.0  # the evolve section of run()
        # of that section: the wall seconds the searching thread waited on
        # the card, and its own CPU seconds outside those waits; the rest
        # it stalled (runnable without the interpreter lock or a core, or
        # blocked in a call that is not one of those waits)
        self.last_wait_seconds = 0.0
        self.last_cpu_seconds = 0.0
        # of that section: the seconds spent capturing CUDA graphs
        self.last_capture_seconds = 0.0
        self._waited = [0.0, 0.0]  # the current run's waits: wall, CPU
        self.last_rerank_seconds = 0.0  # surrogate train + re-rank
        self._key = key_data(cfg.seed)
        # the fault half is scored only when faults can be non-zero
        self._coin = (te.fault_coin(cfg.seed, cfg.H)
                      if cfg.ga.max_fault > 0 else None)
        self._traces = _ResidentTraces(self.device)
        # the knowledge service's shared surrogate, ``feats [N, K'] ->
        # probs [N] | None``: consulted only while the local surrogate is
        # too thin to train; None (or a None answer) keeps the local pick
        self.remote_surrogate = None
        # causality guidance: the relation-coverage map and, slot-aligned
        # with the archive, each run's DAG-shape fragment f32[size, G];
        # both None = the unguided search
        self.guidance: Optional[CoverageMap] = None
        self.guidance_feats: Optional[np.ndarray] = None
        # where the search reports its phases and rounds (obs.py)
        self.telemetry = NULL
        self._upload_archives()

    # -- archives ----------------------------------------------------------

    def _upload_archives(self) -> None:
        self._dev_pairs = torch.from_numpy(
            self.pairs.astype(np.int64)).to(self.device)
        self._dev_archive = torch.tensor(self.archive, device=self.device)
        self._dev_failures = torch.tensor(self.failures, device=self.device)
        self._dev_coin = (None if self._coin is None else
                          torch.from_numpy(self._coin).to(self.device))

    # -- causality guidance ------------------------------------------------

    def enable_guidance(self, width: Optional[int] = None,
                        window: Optional[int] = None,
                        fresh: bool = False) -> CoverageMap:
        """Wire the relation-coverage map and return it. Idempotent; a
        changed bitmap space, or ``fresh`` (every ingest passes it: the map
        is rebuilt from the whole stored history each time), builds a new
        map. Wiring guidance onto a live search widens the surrogate's
        features, so a surrogate of the old width and archive rows without
        fragments are dropped; the next ingest refills them."""
        width = int(width or DEFAULT_WIDTH)
        window = int(window or DEFAULT_WINDOW)
        g = self.guidance
        if (g is None or fresh or g.width != width or g.window != window
                or g.H != self.cfg.H):
            self.guidance = CoverageMap(H=self.cfg.H, width=width,
                                        window=window)
        if self.guidance_feats is None:
            self.guidance_feats = np.zeros(
                (self.cfg.archive_size, GUIDANCE_DIMS), np.float32)
            if getattr(self, "_surrogate", None) is not None:
                self._surrogate = None
            if self._archive_n > 0:
                self.archive[:] = 0.5
                self.archive_labels[:] = 0.0
                self._archive_n = 0
                self._upload_archives()
        return self.guidance

    def _guidance_dims(self) -> int:
        return (0 if self.guidance_feats is None
                else self.guidance_feats.shape[1])

    def _guidance_feats_of(self, realized: te.EncodedTrace,
                           arrival: Optional[te.EncodedTrace]
                           ) -> np.ndarray:
        """The DAG-shape fragment of one executed run: program order from
        the arrival view, dispatch order from the realized one (the
        realized view anchors both without an arrival view)."""
        src = arrival if arrival is not None else realized
        m = realized.mask
        return dag_shape_features(
            realized.hint_ids[m], src.arrival[m], realized.arrival[m],
            width=self.guidance.width, dims=self._guidance_dims())

    def _feats_of(self, encoded: te.EncodedTrace) -> np.ndarray:
        trace = TraceArrays(
            torch.from_numpy(encoded.hint_ids.astype(np.int64)).to(
                self.device),
            torch.from_numpy(encoded.arrival).to(self.device),
            torch.from_numpy(encoded.mask).to(self.device),
        )
        f = trace_features(trace, self._dev_pairs, self.cfg.weights.tau,
                           self.cfg.H)
        return f.cpu().numpy()

    def set_occupied_buckets(self, occupied) -> None:
        """Refit the precedence pairs to the hint buckets observed in the
        recorded traces (``te.informative_pairs``). When the pairs change,
        every stored feature is in the old space: the archives, their
        labels and the failure digests are cleared on the host and on the
        device, and the best-so-far is reset."""
        new = te.informative_pairs(occupied, self.cfg.K, self.cfg.H,
                                   self.cfg.seed)
        if np.array_equal(new, self.pairs):
            return
        self.pairs = new
        self.archive[:] = 0.5
        self.archive_labels[:] = 0.0
        if self.guidance_feats is not None:
            self.guidance_feats[:] = 0.0  # slot-aligned with the archive
        self._archive_n = 0
        self.failures[:] = 0.5
        self._failure_n = 0
        self._failure_digests = [""] * self.cfg.failure_size
        self._failure_digest_set.clear()
        self._upload_archives()
        self._reset_best()

    def _reset_best(self) -> None:
        """Invalidate the best-so-far record (the feature space changed)."""
        raise NotImplementedError

    def add_executed_trace(self, encoded: te.EncodedTrace,
                           reproduced: bool = False,
                           arrival: Optional[te.EncodedTrace] = None
                           ) -> None:
        """Record an executed run's interleaving into the novelty archive,
        labeled with whether it reproduced the bug (the surrogate's
        target). With guidance wired, the slot's DAG-shape fragment is
        written from this view and ``arrival`` (the run's arrival view)."""
        slot = self._archive_n % self.cfg.archive_size
        self.archive[slot] = self._feats_of(encoded)
        self.archive_labels[slot] = 1.0 if reproduced else 0.0
        if self.guidance_feats is not None:
            self.guidance_feats[slot] = self._guidance_feats_of(encoded,
                                                                arrival)
        self._archive_n += 1
        self._dev_archive[slot].copy_(torch.from_numpy(self.archive[slot]))

    def add_failure_trace(self, encoded: te.EncodedTrace) -> None:
        """Record a bug-reproducing run; idempotent per distinct signature."""
        digest = trace_digest(encoded)
        if digest in self._failure_digest_set:
            return
        slot = self._failure_n % self.cfg.failure_size
        evicted = self._failure_digests[slot]
        if evicted:
            self._failure_digest_set.discard(evicted)
        self.failures[slot] = self._feats_of(encoded)
        self._failure_digests[slot] = digest
        self._failure_digest_set.add(digest)
        self._failure_n += 1
        self._dev_failures[slot].copy_(
            torch.from_numpy(self.failures[slot]))

    def distinct_failure_signatures(self) -> int:
        return len(self._failure_digest_set)

    def has_failure_signature(self, digest: str) -> bool:
        return digest in self._failure_digest_set

    def _record_progress(self, generations: int, elapsed: float,
                         schedules: float, best_fitness: float,
                         host_io_s: Optional[float] = None,
                         fit_curve: Optional[list] = None) -> None:
        """One ``run()``'s round to ``telemetry``, with the archives'
        occupancies: ``search_round`` (rates, best fitness) and
        ``record_generation`` (the flight recorder's round, the fused
        loop's host-I/O seconds and per-generation curve)."""
        occupancy = dict(
            archive_entries=min(self._archive_n, self.cfg.archive_size),
            failure_entries=min(self._failure_n, self.cfg.failure_size),
            distinct_failures=self.distinct_failure_signatures())
        self.telemetry.search_round(
            self.BACKEND, generations, elapsed, schedules=schedules,
            best_fitness=best_fitness, host_io_s=host_io_s, **occupancy)
        self.telemetry.record_generation(
            self.BACKEND, generations, elapsed, best_fitness,
            host_io_s=host_io_s, fit_curve=fit_curve, **occupancy)

    def labeled_archive(self):
        """``(feats [N, K'], labels [N])`` of the populated archive slots
        whose outcome is known (NaN labels are excluded); with guidance
        wired, ``K' = K + GUIDANCE_DIMS`` (each slot's fragment)."""
        n = min(self._archive_n, self.cfg.archive_size)
        feats, labels = self.archive[:n], self.archive_labels[:n]
        if self.guidance_feats is not None:
            feats = np.hstack([feats, self.guidance_feats[:n]])
        known = np.isfinite(labels)
        return feats[known], labels[known]

    # -- search ------------------------------------------------------------

    @property
    def _seed(self) -> int:
        return seed_of_key(self._key)

    def _device_inputs(self, encoded):
        """``(traces, pairs, archive, failures)`` on the device, from one
        encoded trace or a list of them; the traces carry the faultable
        flag only when the fault half is scored."""
        encs = encoded if isinstance(encoded, (list, tuple)) else [encoded]
        return (self._traces.view(encs, faultable=self._coin is not None),
                self._dev_pairs, self._dev_archive, self._dev_failures)

    def _sync(self) -> None:
        """Wait for the work queued on the device's current stream, where
        a run queues all of its own (a device-wide sync would also break
        a CUDA graph capture under way on another thread)."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def _start_clocks(self) -> float:
        """Start counting a run's waits; returns the thread's CPU clock.
        Take it after the run's wall stamp ``t0``, and stop the clocks
        with both (``_stop_clocks``)."""
        self._waited = [0.0, 0.0]
        return time.thread_time()

    def _stop_clocks(self, t0: float, cpu0: float) -> None:
        """Set the run's wall, wait and CPU seconds. A thread's CPU clock
        may move in ticks (every 10 ms on some hosts), so a run's CPU can
        read above the wall it lies in: it is capped at the wall left
        outside the waits."""
        cpu = time.thread_time() - cpu0 - self._waited[1]
        self.last_run_seconds = time.perf_counter() - t0
        self.last_wait_seconds = self._waited[0]
        self.last_cpu_seconds = min(
            cpu, self.last_run_seconds - self.last_wait_seconds)

    @contextlib.contextmanager
    def _on_card(self):
        """A block in which the searching thread waits on the card: its
        wall seconds add to the run's wait, and its CPU seconds (a CUDA
        sync may spin) leave the run's CPU."""
        c0 = time.thread_time()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._waited[0] += time.perf_counter() - t0
            self._waited[1] += time.thread_time() - c0

    # -- persistence -------------------------------------------------------

    def _state_dict(self) -> dict:
        raise NotImplementedError

    def _restore_state(self, arrays: dict) -> None:
        raise NotImplementedError

    def save(self, path: str) -> None:
        """Write the reference's checkpoint keys (``.npz``)."""
        flat = {
            "backend": np.asarray(self.BACKEND),
            "hint_space": np.asarray(te.HINT_SPACE),
            "pairs": self.pairs,
            "archive": self.archive,
            "archive_labels": self.archive_labels,
            "archive_n": np.asarray(self._archive_n),
            "failures": self.failures,
            "failure_n": np.asarray(self._failure_n),
            "failure_digests": np.asarray(self._failure_digests),
            "key": self._key,
            "generations_run": np.asarray(self.generations_run),
        }
        if self.guidance_feats is not None:
            flat["guidance_feats"] = self.guidance_feats
        flat.update(self._state_dict())
        tmp = path + ".tmp.npz"
        np.savez(tmp, **flat)
        os.replace(tmp, path)

    def load(self, path: str) -> None:
        """Restore a checkpoint written by this package or by the
        reference's search of the same backend; a checkpoint of the other
        backend raises ``ValueError``. A guided search keeps the
        checkpoint's ``guidance_feats``; a checkpoint without them (or of
        another size) has no fragments for its archive rows, so the
        archive is dropped and the next ingest refills it."""
        with np.load(path) as z:
            arrays = {k: z[k] for k in z.files}
        saved = str(arrays["backend"]) if "backend" in arrays else "ga"
        if saved != self.BACKEND:
            raise ValueError(f"checkpoint {path} was written by the "
                             f"{saved!r} backend, not {self.BACKEND!r}")
        if ("best_delays" in arrays
                and arrays["best_delays"].shape != (self.cfg.H,)):
            raise ValueError(
                f"checkpoint {path} has H={arrays['best_delays'].shape[0]} "
                f"delay buckets, config has H={self.cfg.H}")
        space = te.checkpoint_hint_space(arrays)
        if space != te.HINT_SPACE:
            raise ValueError(
                f"checkpoint {path} was built in hint space {space!r}; "
                f"this build hashes {te.HINT_SPACE!r}")
        got = convert.archives_from_jax(arrays)
        if got.pairs is not None:
            self.pairs = got.pairs
        self.archive, self._archive_n = got.archive, got.archive_n
        self.failures, self._failure_n = got.failures, got.failure_n
        self.archive_labels = (
            np.array(arrays["archive_labels"], np.float32)
            if "archive_labels" in arrays
            # outcomes of the archived runs unknown: NaN marks them
            else np.full((self.cfg.archive_size,), np.nan, np.float32))
        if self.guidance_feats is not None:
            if (got.guidance_feats is not None and
                    got.guidance_feats.shape == self.guidance_feats.shape):
                self.guidance_feats = got.guidance_feats
            else:
                self.archive[:] = 0.5
                self.archive_labels[:] = 0.0
                self._archive_n = 0
        if "failure_digests" in arrays:
            self._failure_digests = [str(d) for d in
                                     arrays["failure_digests"]]
        else:
            self._failure_digests = [""] * self.cfg.failure_size
        self._failure_digest_set = {d for d in self._failure_digests if d}
        self._key = np.asarray(arrays["key"], np.uint32).reshape(2)
        self.generations_run = int(arrays["generations_run"])
        self._restore_state(arrays)
        self._upload_archives()


def _graph_count(name: str, doc: str) -> property:
    return property(lambda self: getattr(self._graphs, name, 0), doc=doc)


class ScheduleSearch(SearchBase):
    """The GA backend: ``cfg.population`` genomes (rounded down to a
    multiple of the islands) over the islands of ``mesh``, or of
    ``make_mesh(n_devices)`` on ``device``; one island on one card by
    default. A mesh with an ``h`` axis migrates over :func:`hier_rings`,
    else over one ring on ``i``. On a CUDA device with the mesh in one
    shard, the fused loop replays its chunks as captured CUDA graphs
    (``parallel/graphs.py``); the ``graph_*`` counts are the search's
    chunks of those since it was built (0 elsewhere)."""

    BACKEND = "ga"

    graph_captures = _graph_count(
        "captures", "chunks captured as CUDA graphs (and then replayed)")
    graph_replays = _graph_count(
        "replays", "chunks replayed from a graph captured before")
    graph_fallbacks = _graph_count(
        "fallbacks", "chunks run eagerly on a device where graphs replay")
    graph_evictions = _graph_count(
        "evictions", "graphs of this search dropped for memory")

    #: labeled runs needed in EACH outcome class before the surrogate may
    #: override the fitness argmax
    MIN_CLASS_EXAMPLES = 3

    def __init__(self, cfg: SearchConfig = SearchConfig(),
                 mesh: Optional[IslandMesh] = None,
                 n_devices: Optional[int] = None,
                 device: DeviceLike = "cuda"):
        super().__init__(cfg, _mesh_for(mesh, n_devices, device))
        n_islands = self.mesh.n_islands
        self.population = max(1, cfg.population // n_islands) * n_islands
        if "h" in self.mesh.axis_names:
            self._rings = hier_rings(migrate_k=cfg.migrate_k,
                                     migrate_every=cfg.migrate_every,
                                     dcn_every=cfg.dcn_migrate_every)
        else:
            self._rings = (("i", cfg.migrate_k, cfg.migrate_every),)
        self.last_fit_curve: List[float] = []
        self._surrogate: Optional[RewardSurrogate] = None
        self._device_traced = False  # the one-shot device-trace latch
        # the best fitness of the last completed round, the floor of the
        # progress the fused loop publishes
        self._round_best = float("-inf")
        self._state = init_island_state(cfg.seed + 1, self.population,
                                        cfg.H, cfg.ga, mesh=self.mesh)
        self._graphs = ChunkGraphs(self.mesh) if eligible(self.mesh) else None

    def _reset_best(self) -> None:
        self._state = self._state._replace(best_fitness=torch.full(
            (), float("-inf"), device=self.device))

    def seed_population(self, delay_tables) -> None:
        """Write imitation genomes (recorded failures' delay tables,
        clipped to ``max_delay``) into the population before evolving,
        one every ``P // n`` rows of the whole population, so every
        island gets tables. The device population is written in place,
        not reallocated. A no-op on a mesh over several processes, as in
        the reference: per-process seeding would make the processes'
        populations diverge."""
        if len(delay_tables) == 0 or self.mesh.world > 1:
            return
        seeds = np.clip(
            np.stack([np.asarray(t, np.float32) for t in delay_tables]),
            0.0, self.cfg.ga.max_delay)
        n = min(seeds.shape[0], self.population)
        stride = max(1, self.population // n)
        idx = np.array([min(i * stride, self.population - 1)
                        for i in range(n)])
        Pi = self.population // self.mesh.n_islands
        parts = ([self._state.pop.delays]
                 if torch.is_tensor(self._state.pop.delays)
                 else self._state.pop.delays)
        for sh, delays in zip(self.mesh.shards, parts):
            lo = sh.start * Pi
            mine = (idx >= lo) & (idx < lo + delays.shape[0])
            if mine.any():
                delays[torch.from_numpy(idx[mine] - lo).to(sh.device)] = \
                    torch.from_numpy(seeds[:n][mine]).to(sh.device)

    def novelty_scale(self) -> float:
        """Annealed multiplier on ``weights.novelty``: 1.0 while the
        failure archive holds fewer than ``min_failure_signatures``
        distinct signatures, then threshold/n, floored."""
        ms = self.cfg.min_failure_signatures
        if ms <= 0:
            return 1.0
        n = self.distinct_failure_signatures()
        if n < ms:
            return 1.0
        return max(self.cfg.novelty_floor, ms / n)

    # -- search ------------------------------------------------------------

    def run(self, encoded, generations: int = 50) -> BestSchedule:
        """Evolve against one or more reference traces for ``generations``
        generations. Returns the best schedule seen so far (monotonic
        across calls), unless ``surrogate_topk > 0`` and the surrogate
        has trained: then the surrogate's pick among the current
        population's top-k by fitness, whose fitness may lie below
        ``best().fitness``. A failure inside the evolve section leaves
        the search as the last completed ``run()`` left it: a step
        replaces the island state and never writes into it."""
        tel = self.telemetry
        t0 = time.perf_counter()
        cpu0 = self._start_clocks()
        encs = encoded if isinstance(encoded, (list, tuple)) else [encoded]
        with search_phase(tel, "encode"):
            inputs = self._device_inputs(encs)
        nov_scale = self.novelty_scale()
        # guided mutation: buckets of one-sided relations mutate more often
        bias = (None if self.guidance is None else torch.from_numpy(
            self.guidance.mutation_bias()).to(self.device))
        start, host_io = self._state, None
        self.last_capture_seconds = 0.0
        t_evolve = time.perf_counter()
        with search_phase(tel, "evolve"):
            try:
                if self.cfg.fused:
                    trace = self._start_device_trace()
                    try:
                        curve, host_io = self._run_fused(
                            inputs, nov_scale, generations, bias)
                    finally:
                        if trace is not None:
                            self._stop_device_trace(*trace)
                else:
                    curve = self._run_stepwise(inputs, nov_scale,
                                               generations, bias)
                with self._on_card():
                    self._sync()
            except BaseException:
                self._state = start
                raise
        self._stop_clocks(t0, cpu0)
        elapsed = time.perf_counter() - t_evolve
        self.last_fit_curve = curve
        self.generations_run += generations
        self._round_best = float(self._state.best_fitness)
        schedules = generations * self.population
        if self.cfg.fused:
            tel.scorer_throughput("fused", schedules / max(elapsed, 1e-9))
        self._record_progress(generations, elapsed, schedules,
                              self._round_best, host_io_s=host_io,
                              fit_curve=curve if self.cfg.fused else None)
        t0 = time.perf_counter()
        with search_phase(tel, "surrogate"):
            picked = self._surrogate_pick(*inputs, nov_scale, encs=encs)
        self.last_rerank_seconds = time.perf_counter() - t0
        if picked is not None:
            return picked
        with search_phase(tel, "extract"):
            return self.best()

    def _start_device_trace(self):
        """Start the one-shot ``torch.profiler`` capture of this evolve
        section when ``cfg.device_trace_dir`` is set and nothing was
        captured yet; ``(profiler, out dir)`` or None. A profiler that
        cannot start logs one warning and the search runs untraced, on
        the same device."""
        if not self.cfg.device_trace_dir or self._device_traced:
            return None
        self._device_traced = True
        out = os.path.join(self.cfg.device_trace_dir, "device_trace")
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        try:
            os.makedirs(out, exist_ok=True)
            prof = torch.profiler.profile(activities=acts)
            start_profiler(prof, self.device)
        except Exception as e:
            log.warning("device-trace capture unavailable (%s); the search "
                        "runs untraced", e)
            return None
        log.info("capturing a device trace of this evolve section into %s",
                 out)
        return prof, out

    def _stop_device_trace(self, prof, out: str) -> None:
        """Stop the capture once the device is done, and write it as a
        Chrome trace; a failure here is logged and never masks the evolve
        section's outcome."""
        try:
            self._sync()
            stop_profiler(prof, self.device)
            prof.export_chrome_trace(os.path.join(
                out, f"evolve_{os.getpid()}_{time.time_ns()}.json"))
        except Exception:
            log.warning("device-trace export failed", exc_info=True)
            return
        self.telemetry.search_device_trace(out)

    def _run_stepwise(self, inputs, nov_scale, generations: int,
                      bias: Optional[torch.Tensor] = None) -> List[float]:
        """One island step per generation: the fused path's reference."""
        traces, pairs, archive, failures = inputs
        fits = []
        for _ in range(generations):
            self._state, fit = island_step(
                self._state, self._seed, traces, pairs, archive, failures,
                self.cfg.ga, self.cfg.weights, novelty_scale=nov_scale,
                mutation_bias=bias, coin=self._dev_coin, mesh=self.mesh,
                rings=self._rings)
            fits.append(fit)
        if not fits:
            return []
        with self._on_card():
            curve = torch.stack(fits).tolist()
        return [float(v) for v in curve]

    def _run_fused(self, inputs, nov_scale, generations: int,
                   bias: Optional[torch.Tensor] = None):
        """Generations in chunks of ``fused_chunk``, each one call with no
        host sync inside, or, where the search has graphs, one replay of
        the chunk's captured graph (captured first where needed); a
        replayed chunk's state lives in the graph's outputs, and the
        run's last one is copied out at its end. A chunk's best-fitness
        history is copied to the host asynchronously and read only after
        the next chunk has been queued, so the host never waits on the
        chunk still running. Returns the per-generation curve and the
        seconds spent reading it (the host-I/O lane)."""
        traces, pairs, archive, failures = inputs
        graphs = self._graphs
        step = (graphs.step if graphs is not None
                else functools.partial(fused_step, mesh=self.mesh))
        curve: List[float] = []
        host_io = 0.0
        pending = None
        done = 0
        if graphs is not None:
            graphs.begin()
        try:
            while done < generations:
                g = min(self.cfg.fused_chunk, generations - done)
                self._state, fit_hist = step(
                    self._state, g, self._seed, traces, pairs, archive,
                    failures, self.cfg.ga, self.cfg.weights,
                    novelty_scale=nov_scale, mutation_bias=bias,
                    coin=self._dev_coin, rings=self._rings)
                done += g
                if pending is not None:
                    host_io += self._drain(pending, curve)
                pending = self._stage(fit_hist)
            if pending is not None:
                host_io += self._drain(pending, curve)
            if graphs is not None:
                self._state = graphs.own(self._state)
        finally:
            if graphs is not None:
                graphs.end()
                self.last_capture_seconds = graphs.capture_seconds
        return curve, host_io

    def _stage(self, fit_hist: torch.Tensor):
        if fit_hist.device.type != "cuda":
            return fit_hist, None
        host = torch.empty(fit_hist.shape, dtype=fit_hist.dtype,
                           pin_memory=True)
        host.copy_(fit_hist, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    def _drain(self, staged, curve: List[float]) -> float:
        """Append a staged chunk's history to ``curve`` and publish the
        best fitness so far (never below the last round's); returns the
        seconds it took."""
        t0 = time.perf_counter()
        with search_phase(self.telemetry, "host_io"):
            host, done = staged
            if done is not None:
                with self._on_card():
                    done.synchronize()
            curve.extend(float(v) for v in host.tolist())
            if curve:
                self.telemetry.search_progress(
                    self.BACKEND, max(self._round_best, max(curve)))
        return time.perf_counter() - t0

    def _full_population(self) -> Population:
        """Every island's genomes, flat ``[P, H]`` on the primary device;
        on a mesh over several processes gathered from all of them."""
        pop = local_population(self._state.pop, self.mesh)
        if self.mesh.distributed:
            pop = Population(*(self.mesh.all_gather(x).flatten(0, 1)
                               for x in pop))
        return pop

    def _fetch_population(self):
        """The population as host numpy arrays ``(delays, faults)``."""
        pop = self._full_population()
        return pop.delays.cpu().numpy(), pop.faults.cpu().numpy()

    # -- surrogate ---------------------------------------------------------

    def _surrogate_input_dims(self) -> int:
        """The surrogate's feature width: K, plus the DAG-shape fragment
        with guidance wired (the knowledge service walls its example
        stores by this width)."""
        return self.cfg.K + self._guidance_dims()

    def _train_surrogate(self) -> Optional[RewardSurrogate]:
        """Fit the MLP on the labeled archive (4 epochs, seeded by the
        generations run so far); None while surrogate use is off or
        either outcome class holds fewer than MIN_CLASS_EXAMPLES."""
        if self.cfg.surrogate_topk <= 0:
            return None
        feats, labels = self.labeled_archive()
        pos = int((labels > 0.5).sum())
        neg = int(len(labels) - pos)
        if min(pos, neg) < self.MIN_CLASS_EXAMPLES:
            return None
        if self._surrogate is None:
            self._surrogate = RewardSurrogate(
                K=self._surrogate_input_dims(), seed=self.cfg.seed,
                device=self.device)
        self._surrogate.train(feats, labels, epochs=4,
                              seed=self.cfg.seed + self.generations_run)
        return self._surrogate

    def _rerank_candidates(self, traces, pairs, archive, failures,
                           nov_scale=None):
        """``(top-k row indices, fitness [P], feats [P, T, K])`` of the
        current population, re-scored once, its fault half included."""
        k = min(self.cfg.surrogate_topk, self.population)
        pop = self._full_population()
        fitness, feats = score_population_multi(
            pop.delays, traces, pairs, archive, failures, self.cfg.weights,
            faults=None if self._dev_coin is None else pop.faults,
            coin=self._dev_coin, novelty_scale=nov_scale)
        return torch.argsort(-fitness, stable=True)[:k], fitness, feats

    def _candidate_guidance(self, delays: np.ndarray, encs):
        """``(gains f32[k], fragments f32[k, G])`` of candidate delay
        tables, each simulated against the first reference trace under
        delay mode's release rule (``arrival + delays[bucket]``)."""
        enc = encs[0]
        m = enc.mask
        buckets = enc.hint_ids[m]
        arrivals = enc.arrival[m]
        k = delays.shape[0]
        gains = np.zeros((k,), np.float32)
        frags = np.zeros((k, self._guidance_dims()), np.float32)
        for i in range(k):
            times = arrivals + delays[i][buckets]
            order = np.argsort(times, kind="stable")
            gains[i] = self.guidance.predicted_gain(buckets[order])
            frags[i] = dag_shape_features(
                buckets, arrivals, times, width=self.guidance.width,
                dims=self._guidance_dims())
        return gains, frags

    def _surrogate_pick(self, traces, pairs, archive, failures,
                        nov_scale=None, encs=()) -> Optional[BestSchedule]:
        """Re-score the current population once (one pair-kernel launch)
        and re-rank its top-k by fitness (stable descending sort, ties to
        the lower index); None = the fitness argmax.

        The base score is P(reproduce) from the local surrogate once it
        trains, before that from ``remote_surrogate``, and with neither
        (or a remote answering None) the top-k's min-max-normalized
        fitness, but only when guided. Candidate features are averaged
        over the reference traces, widened by the DAG-shape fragments
        with guidance wired. A guided pick (a map and the reference
        traces ``encs``) adds ``guidance_bonus`` times each candidate's
        predicted coverage gain."""
        surrogate = self._train_surrogate()
        remote = self.remote_surrogate if surrogate is None else None
        guided = self.guidance is not None and len(encs) > 0
        if self.cfg.surrogate_topk <= 0:
            return None
        if surrogate is None and remote is None and not guided:
            return None
        top, fitness, feats = self._rerank_candidates(
            traces, pairs, archive, failures, nov_scale)
        cand_feats = feats[top].mean(dim=1).cpu().numpy()
        pop = self._full_population()
        gains = frags = None
        if guided:
            gains, frags = self._candidate_guidance(
                pop.delays[top].cpu().numpy(), encs)
        base = None
        if surrogate is not None or remote is not None:
            full = (cand_feats if frags is None
                    else np.hstack([cand_feats, frags]))
            base = (surrogate.predict(full) if surrogate is not None
                    else remote(full))
        if base is None:
            if gains is None:
                return None  # the remote is out or untrained: argmax
            f = fitness[top].cpu().numpy()
            span = float(f.max() - f.min())
            base = (f - f.min()) / span if span > 0 else np.zeros_like(f)
        score = (np.asarray(base) if gains is None
                 else np.asarray(base) + self.cfg.guidance_bonus * gains)
        winner = int(top[int(np.argmax(score))])
        return BestSchedule(
            delays=pop.delays[winner].cpu().numpy(),
            faults=pop.faults[winner].cpu().numpy(),
            fitness=float(fitness[winner]),
        )

    def best(self) -> BestSchedule:
        return BestSchedule(
            delays=self._state.best_delays.cpu().numpy(),
            faults=self._state.best_faults.cpu().numpy(),
            fitness=float(self._state.best_fitness),
        )

    # -- persistence -------------------------------------------------------

    def _state_dict(self) -> dict:
        flat = convert.state_to_jax(self._state._replace(
            pop=self._full_population()))
        if self._surrogate is not None:
            flat["surrogate_params"] = convert.surrogate_flat_from_state(
                self._surrogate.state_dict())
        return flat

    def _restore_state(self, arrays: dict) -> None:
        state = convert.island_state_from_jax(arrays, self.device)
        if tuple(state.pop.delays.shape) != (self.population, self.cfg.H):
            # a population/genome-width mismatch (another config, or a
            # mesh whose islands do not divide it) keeps the fresh
            # population; archives, best tables and the key restore
            state = state._replace(pop=self._state.pop)
        else:
            state = state._replace(pop=shard_population(state.pop,
                                                        self.mesh))
        self._state = state
        if "surrogate_params" in arrays:
            # the optimizer restarts, as in the reference; weights of
            # another feature width (guidance toggled since the save)
            # retrain from the labeled archive
            K = self._surrogate_input_dims()
            self._surrogate = RewardSurrogate(K=K, seed=self.cfg.seed,
                                              device=self.device)
            try:
                self._surrogate.load_state_dict(
                    convert.surrogate_state_from_flat(
                        arrays["surrogate_params"], K))
            except ValueError:
                self._surrogate = None


class MCTSSearch(SearchBase):
    """The MCTS backend (``models/mcts.py``) behind the GA's driver API,
    so the ``tpu_search`` policy's ``search_backend = "mcts"`` is served
    by the same sidecar: root-parallel, one tree an island of ``mesh``
    (of ``make_mesh(n_devices)`` on ``device``; one tree by default)."""

    BACKEND = "mcts"

    #: seed tables are tiled to this fixed row count, as in the reference
    SEED_ROWS = 16

    def __init__(self, cfg: SearchConfig = SearchConfig(),
                 mcts_cfg: Optional[MCTSConfig] = None,
                 mesh: Optional[IslandMesh] = None,
                 n_devices: Optional[int] = None,
                 device: DeviceLike = "cuda"):
        super().__init__(cfg, _mesh_for(mesh, n_devices, device))
        self.mcts_cfg = mcts_cfg if mcts_cfg is not None else MCTSConfig(
            max_delay=cfg.ga.max_delay, max_fault=cfg.ga.max_fault)
        if self.mcts_cfg.max_fault > 0 and self._coin is None:
            # an explicit mcts_cfg can enable fault search even when
            # cfg.ga does not: the rollouts still need the coin
            self._coin = te.fault_coin(cfg.seed, cfg.H)
            self._upload_archives()
        if self.mcts_cfg.tree_depth > cfg.H:
            # the tree cannot decide more buckets than the genome has
            self.mcts_cfg = self.mcts_cfg._replace(tree_depth=cfg.H)
        self._best_fitness = float("-inf")
        self._best_delays = np.zeros((cfg.H,), np.float32)
        self._best_faults = np.zeros((cfg.H,), np.float32)
        self._seed_tables: Optional[np.ndarray] = None  # f32[S, H]

    def _reset_best(self) -> None:
        self._best_fitness = float("-inf")

    def seed_population(self, delay_tables) -> None:
        """Demonstration tables steer the rollouts: up to half of each
        rollout batch completes the unpinned buckets from a
        noise-perturbed seed (the MCTS analogue of the GA's population
        seeding, from the same recorded failures)."""
        if len(delay_tables) == 0:
            return
        raw = np.clip(
            np.stack([np.asarray(t, np.float32) for t in delay_tables]),
            0.0, self.mcts_cfg.max_delay)
        reps = -(-self.SEED_ROWS // raw.shape[0])
        self._seed_tables = np.tile(raw, (reps, 1))[: self.SEED_ROWS]

    def _hint_order(self, encs) -> np.ndarray:
        """Bucket ids by frequency across the reference traces, most
        frequent first; the tree decides the most-often-hit buckets
        first. numpy's default sort, as in the reference, so tied counts
        pin the reference's buckets."""
        counts = np.zeros((self.cfg.H,), np.int64)
        for e in encs:
            counts += np.bincount(e.hint_ids[e.mask], minlength=self.cfg.H)
        return np.argsort(-counts)[
            : self.mcts_cfg.tree_depth].astype(np.int32)

    def _next_search_seed(self) -> int:
        """The seed of the next search; advances the key, so a saved and
        loaded search continues the stream."""
        s = seed_of_key(self._key)
        self._key = key_data(generation_seed(s, 0))
        return generation_seed(s, 1)

    def run(self, encoded, generations: int = 1) -> BestSchedule:
        """Run ``max(1, generations // 64)`` independent root-parallel
        searches of ``mcts_cfg.simulations`` simulations a tree (the GA's
        ``generations`` knob maps onto the simulation budget); returns the
        best schedule seen so far (monotonic across calls)."""
        encs = encoded if isinstance(encoded, (list, tuple)) else [encoded]
        t0 = time.perf_counter()
        cpu0 = self._start_clocks()
        traces, pairs, archive, failures = self._device_inputs(encs)
        hint_order = self._hint_order(encs)
        seeds = (None if self._seed_tables is None else
                 torch.from_numpy(self._seed_tables).to(self.device))
        searches = max(1, generations // 64)
        t_evolve = time.perf_counter()
        for _ in range(searches):
            fit, d, f = parallel_mcts(
                self._next_search_seed(), self.mesh, traces, pairs,
                archive, failures, hint_order, self.cfg.H, self.mcts_cfg,
                self.cfg.weights, coin=self._dev_coin, seeds=seeds)
            with self._on_card():
                fit = float(fit)
            if fit > self._best_fitness:
                self._best_fitness = fit
                self._best_delays = d.cpu().numpy()
                self._best_faults = f.cpu().numpy()
        self._stop_clocks(t0, cpu0)
        elapsed = time.perf_counter() - t_evolve
        sims = searches * self.mcts_cfg.simulations
        self.generations_run += sims
        self._record_progress(sims, elapsed, sims * self.mcts_cfg.rollouts,
                              self._best_fitness)
        return self.best()

    def best(self) -> BestSchedule:
        return BestSchedule(delays=self._best_delays,
                            faults=self._best_faults,
                            fitness=self._best_fitness)

    # -- persistence -------------------------------------------------------

    def _state_dict(self) -> dict:
        return {
            "best_fitness": np.asarray(self._best_fitness, np.float32),
            "best_delays": self._best_delays,
            "best_faults": self._best_faults,
        }

    def _restore_state(self, arrays: dict) -> None:
        self._best_fitness = float(arrays["best_fitness"])
        self._best_delays = np.array(arrays["best_delays"], np.float32)
        self._best_faults = np.array(arrays["best_faults"], np.float32)
