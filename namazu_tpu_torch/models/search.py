"""ScheduleSearch: the host-side controller of the island GA, ported from
``namazu_tpu/models/search.py`` (``SearchBase`` + ``ScheduleSearch``).

Owns the precedence pairs and the novelty/failure archives (host ring
buffers with device copies written in place), keeps the reference traces
on the device keyed by content, runs generations on one card, and
extracts the best delay table for the control plane to replay.

Checkpoints keep the reference's ``.npz`` keys, ``key`` included (the
uint32[2] that ``jax.random.PRNGKey(seed)`` holds), so a checkpoint
written by either package loads into the other. The surrogate re-rank,
causality guidance, the MCTS backend, order mode and fault search are
later slices of the port and raise ``NotImplementedError``.
"""

from __future__ import annotations

import hashlib
import os
import time
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from namazu_tpu_torch import convert
from namazu_tpu_torch.device import DeviceLike, resolve_device
from namazu_tpu_torch.models.ga import GAConfig
from namazu_tpu_torch.ops import trace_encoding as te
from namazu_tpu_torch.ops.schedule import (
    ScoreWeights,
    TraceArrays,
    trace_features,
)
from namazu_tpu_torch.parallel.islands import (
    fused_step,
    init_island_state,
    island_step,
)


class SearchConfig(NamedTuple):
    H: int = te.DEFAULT_H  # hint buckets (genome length)
    L: int = te.DEFAULT_L  # encode-length cap hint (informational)
    K: int = te.DEFAULT_K  # feature pairs
    archive_size: int = 512  # novelty archive capacity
    failure_size: int = 64  # failure archive capacity
    population: int = 4096  # genomes (one island on one card)
    migrate_k: int = 8  # ring migration: unused with one island
    seed: int = 0
    ga: GAConfig = GAConfig()
    weights: ScoreWeights = ScoreWeights()
    surrogate_topk: int = 0  # > 0 is not ported yet
    # novelty anneal: with at least this many distinct failure signatures
    # the novelty weight is scaled by min_failure_signatures / n (never
    # below novelty_floor); 0 disables
    min_failure_signatures: int = 0
    novelty_floor: float = 0.25
    guidance_bonus: float = 0.5  # guidance is not ported yet
    # run the generations in chunks of fused_chunk per call with no host
    # sync inside a chunk; False = one call per generation. Both give the
    # same populations bit for bit.
    fused: bool = True
    fused_chunk: int = 16
    migrate_every: int = 1
    dcn_migrate_every: int = 1
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


def trace_digest(enc: te.EncodedTrace) -> str:
    """Content digest of the masked trace: the hint/entity sequence,
    timing and padding excluded. Two runs that interleaved the same events
    in the same order are one failure signature."""
    m = enc.mask
    h = hashlib.sha256()
    h.update(enc.hint_ids[m].tobytes())
    h.update(enc.entity_ids[m].tobytes())
    return h.hexdigest()[:32]


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

    NAMES = ("hint", "arr", "mask")

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
                "mask": torch.from_numpy(rows["mask"])}

    def _rebuild(self, encs, keys, Lmax: int) -> None:
        self.capacity = max(self.capacity, len(encs))
        self.L = max(self.L, Lmax)
        host = {
            "hint": torch.zeros((self.capacity, self.L), dtype=torch.int64),
            "arr": torch.zeros((self.capacity, self.L), dtype=torch.float32),
            "mask": torch.zeros((self.capacity, self.L), dtype=torch.bool),
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

    def view(self, encs) -> TraceArrays:
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
        hint, arr, mask = (self.bufs[n].index_select(0, idx)[:, :Lmax]
                           .contiguous() for n in self.NAMES)
        return TraceArrays(hint, arr, mask)


def _unsupported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"namazu_tpu_torch: {what} is not ported yet; use namazu_tpu")


class ScheduleSearch:
    """GA search on one card. ``device`` defaults to ``"cuda"``; without a
    card, pass ``device="cpu"`` (the scorer then takes the pair-distance
    kernel's plain version)."""

    BACKEND = "ga"

    def __init__(self, cfg: SearchConfig = SearchConfig(),
                 device: DeviceLike = "cuda"):
        if cfg.surrogate_topk > 0:
            raise _unsupported("the surrogate re-rank (surrogate_topk > 0)")
        if cfg.weights.order_mode:
            raise _unsupported("order mode")
        if cfg.ga.max_fault > 0:
            raise _unsupported("fault search (max_fault > 0)")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.population = cfg.population
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
        self.last_run_seconds = 0.0
        self.last_fit_curve: List[float] = []
        self._key = key_data(cfg.seed)
        self._state = init_island_state(cfg.seed + 1, self.population,
                                        cfg.H, cfg.ga, self.device)
        self._traces = _ResidentTraces(self.device)
        self._upload_archives()

    # -- archives ----------------------------------------------------------

    def _upload_archives(self) -> None:
        self._dev_pairs = torch.from_numpy(
            self.pairs.astype(np.int64)).to(self.device)
        self._dev_archive = torch.tensor(self.archive, device=self.device)
        self._dev_failures = torch.tensor(self.failures, device=self.device)

    def enable_guidance(self, *args, **kwargs):
        raise _unsupported("causality guidance")

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

    def add_executed_trace(self, encoded: te.EncodedTrace,
                           reproduced: bool = False) -> None:
        """Record an executed run's interleaving into the novelty archive,
        labeled with whether it reproduced the bug."""
        slot = self._archive_n % self.cfg.archive_size
        self.archive[slot] = self._feats_of(encoded)
        self.archive_labels[slot] = 1.0 if reproduced else 0.0
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

    @property
    def _seed(self) -> int:
        return seed_of_key(self._key)

    def _device_inputs(self, encoded):
        encs = encoded if isinstance(encoded, (list, tuple)) else [encoded]
        return (self._traces.view(encs), self._dev_pairs,
                self._dev_archive, self._dev_failures)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, encoded, generations: int = 50) -> BestSchedule:
        """Evolve against one or more reference traces for ``generations``
        generations; returns the best schedule seen so far (monotonic
        across calls)."""
        t0 = time.perf_counter()
        if self.cfg.fused:
            curve = self._run_fused(encoded, generations)
        else:
            curve = self._run_stepwise(encoded, generations)
        self._sync()
        self.last_run_seconds = time.perf_counter() - t0
        self.last_fit_curve = curve
        self.generations_run += generations
        return self.best()

    def _run_stepwise(self, encoded, generations: int) -> List[float]:
        """One island step per generation: the fused path's reference."""
        traces, pairs, archive, failures = self._device_inputs(encoded)
        nov_scale = self.novelty_scale()
        fits = []
        for _ in range(generations):
            self._state, fit = island_step(
                self._state, self._seed, traces, pairs, archive, failures,
                self.cfg.ga, self.cfg.weights, novelty_scale=nov_scale)
            fits.append(fit)
        return [float(v) for v in torch.stack(fits).tolist()] if fits else []

    def _run_fused(self, encoded, generations: int) -> List[float]:
        """Generations in chunks of ``fused_chunk``, each one call with no
        host sync inside. A chunk's best-fitness history is copied to the
        host asynchronously and read only after the next chunk has been
        queued, so the host never waits on the chunk still running."""
        traces, pairs, archive, failures = self._device_inputs(encoded)
        nov_scale = self.novelty_scale()
        curve: List[float] = []
        pending = None
        done = 0
        while done < generations:
            g = min(self.cfg.fused_chunk, generations - done)
            self._state, fit_hist = fused_step(
                self._state, g, self._seed, traces, pairs, archive,
                failures, self.cfg.ga, self.cfg.weights,
                novelty_scale=nov_scale)
            done += g
            if pending is not None:
                self._drain(pending, curve)
            pending = self._stage(fit_hist)
        if pending is not None:
            self._drain(pending, curve)
        return curve

    def _stage(self, fit_hist: torch.Tensor):
        if fit_hist.device.type != "cuda":
            return fit_hist, None
        host = torch.empty(fit_hist.shape, dtype=fit_hist.dtype,
                           pin_memory=True)
        host.copy_(fit_hist, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    @staticmethod
    def _drain(staged, curve: List[float]) -> None:
        host, done = staged
        if done is not None:
            done.synchronize()
        curve.extend(float(v) for v in host.tolist())

    def best(self) -> BestSchedule:
        return BestSchedule(
            delays=self._state.best_delays.cpu().numpy(),
            faults=self._state.best_faults.cpu().numpy(),
            fitness=float(self._state.best_fitness),
        )

    # -- persistence -------------------------------------------------------

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
        flat.update(convert.state_to_jax(self._state))
        tmp = path + ".tmp.npz"
        np.savez(tmp, **flat)
        os.replace(tmp, path)

    def load(self, path: str) -> None:
        """Restore a checkpoint written by this package or by the
        reference's ``ScheduleSearch``."""
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
        got = convert.state_from_jax(arrays, self.device)
        if got.pairs is not None:
            self.pairs = got.pairs
        self.archive, self._archive_n = got.archive, got.archive_n
        self.failures, self._failure_n = got.failures, got.failure_n
        self.archive_labels = (
            np.array(arrays["archive_labels"], np.float32)
            if "archive_labels" in arrays
            # outcomes of the archived runs unknown: NaN marks them
            else np.full((self.cfg.archive_size,), np.nan, np.float32))
        if "failure_digests" in arrays:
            self._failure_digests = [str(d) for d in
                                     arrays["failure_digests"]]
        else:
            self._failure_digests = [""] * self.cfg.failure_size
        self._failure_digest_set = {d for d in self._failure_digests if d}
        self._key = np.asarray(arrays["key"], np.uint32).reshape(2)
        self.generations_run = int(arrays["generations_run"])
        state = got.state
        if tuple(state.pop.delays.shape) != (self.population, self.cfg.H):
            # a population/genome-width mismatch keeps the fresh
            # population; archives, best tables and the key restore
            state = state._replace(pop=self._state.pop)
        self._state = state
        self._upload_archives()


class MCTSSearch:
    """The MCTS backend of the reference; not ported yet."""

    BACKEND = "mcts"

    def __init__(self, *args, **kwargs):
        raise _unsupported("the MCTS backend")
