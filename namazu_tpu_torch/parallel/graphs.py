"""Chunks of the fused island step replayed as captured CUDA graphs.

On a CUDA device with the whole mesh in one shard (one island, or several
islands on one card), a search's :class:`ChunkGraphs` captures a chunk of
``g`` generations of :func:`islands.fused_step` into a
``torch.cuda.CUDAGraph`` the first time the search meets a key it has
not captured, and replays the graph for the chunks of that key after: one
graph launch in place of some seventy kernel launches a generation. What
the chunk computes does not change.

* **Key**: what a capture bakes in: the chunk's length, the shapes and
  dtypes of the population, traces, pairs, archives, coin and bias, the
  GA and score settings (Python floats folded into the kernels, but for
  the novelty weight), the mesh's layout and which generations each ring
  migrates in. The inputs are copied into buffers the graph owns, so
  their addresses are not part of it, and the novelty weight (the
  search's annealed scale times ``weights.novelty``) is such an input: a
  0-dim tensor the kernels read, so a new scale is no new key.
* **Draws**: the graph owns one generator a (generation, island),
  registered with it before the capture; before each replay each is seeded
  as :func:`islands.generator_for` seeds that generation's island
  (:func:`islands.chunk_seeds`), and the replay's prologue writes the seed
  and offset 0 to the card: the eager step's Philox streams, bit for bit.
* **State**: a replay reads the population and best-so-far from the
  graph's input buffers and writes the new ones and the chunk's
  best-fitness history into its output buffers, which the next replay
  overwrites; :meth:`ChunkGraphs.own` copies a state out before the search
  keeps it. Input and output buffers are allocated outside the capture.
* **One pool a device**: what a capture allocates is the chunk's
  temporaries alone, dead at its end, so a device's graphs share one
  memory pool: it holds the largest chunk's temporaries once, not each
  graph's. That is sound because a device's replays run one after another
  on its one replay stream, each waiting for the work queued before it on
  the replaying thread's stream, which then waits for it.
* **Capture**: ``thread_local`` mode on a side stream, so another
  thread's stream sync neither breaks a capture nor is broken by it. A key
  the device has never run runs eagerly once first (the chunk's own work),
  so nothing initialises lazily inside a capture. A capture that fails (a
  host sync inside the step, say) logs one warning, and that search runs
  eagerly from then on.
* **Lifecycle**: every capture and every release of a graph on a device
  holds the device's ``lifecycle`` lock. Both touch state that all of a
  device's graphs share and that PyTorch does not guard across threads:
  each capture registers the graph with the card's default generator, in
  a set that each release (``reset``) erases it from again. A graph is
  released only there, never dropped to the garbage collector.
* **Under a profiler**: a graph launch in flight on one thread while
  ``torch.profiler`` stops on another hangs both (the stop holds the
  interpreter lock throughout). So a replay holds the device's ``gate``,
  and a profiler started by :func:`start_profiler` is stopped by
  :func:`stop_profiler` under the gate, with no replay in flight: chunks
  replay under it. While a profiler started otherwise records, chunks run
  eagerly, as nothing then keeps its stop from meeting a launch.
* **Memory**: a device's graphs are held in a set ordered by last
  replay, bounded to ``MEMORY_SHARE`` of the card's memory (their buffers
  and the shared pool): past the bound, graphs that no search is running
  are released, least recently replayed first, and their searches capture
  again on their next chunk.
* **Counts**: a search's chunks captured, replayed (chunks served by a graph
  captured before) and run eagerly on an eligible device, its graphs
  released for memory, and its seconds capturing in the current run. A
  graph holds the B1 and B2 launches its capture made (the capturing
  thread's :func:`pair_distance.thread_launches` across it, counted once
  in ``pair_distance.LAUNCHES`` then, for the chunk the capture serves)
  and adds them there at each later replay.
"""

from __future__ import annotations

import logging
import threading
import time
import warnings
import weakref
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import torch

from namazu_tpu_torch.models.ga import Population
from namazu_tpu_torch.ops import pair_distance
from namazu_tpu_torch.ops.schedule import TraceArrays
from namazu_tpu_torch.parallel.islands import (
    IslandState,
    chunk_seeds,
    fused_step,
    ring_plan,
)
from namazu_tpu_torch.parallel.mesh import IslandMesh

log = logging.getLogger("namazu_tpu_torch.graphs")

#: the share of a card's memory its captured graphs may hold
MEMORY_SHARE = 0.5

_STATE = ("delays", "faults", "best_fitness", "best_delays", "best_faults")
_INPUTS = ("hint_ids", "arrival", "mask", "faultable", "pairs", "archive",
           "failures", "coin", "bias")


def eligible(mesh: IslandMesh) -> bool:
    """Whether a search over ``mesh`` replays its chunks as graphs: a
    CUDA device and one shard in one process."""
    return (mesh.device.type == "cuda" and len(mesh.shards) == 1
            and not mesh.distributed)


def _sig(x: Optional[torch.Tensor]):
    return None if x is None else (tuple(x.shape), x.dtype)


def _state_tensors(state: IslandState) -> Tuple[torch.Tensor, ...]:
    return (state.pop.delays, state.pop.faults, state.best_fitness,
            state.best_delays, state.best_faults)


def _state_of(t: Dict[str, torch.Tensor], gen: int) -> IslandState:
    return IslandState(Population(t["delays"], t["faults"]), gen,
                       t["best_fitness"], t["best_delays"], t["best_faults"])


class _Graph:
    """One captured chunk: the graph, its generators ``[generation]
    [island]``, its input buffers (the novelty weight's among them), its
    output buffers and their bytes."""

    def __init__(self, owner: "ChunkGraphs"):
        self.owner = weakref.ref(owner)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.gens: List[List[torch.Generator]] = []
        self.inputs: Dict[str, Optional[torch.Tensor]] = {}
        self.out: Dict[str, torch.Tensor] = {}
        self.hist: Optional[torch.Tensor] = None
        self.launches = (0, 0)  # B1, B2 a replay
        self.bytes = 0
        self.busy = False  # its search is in a run
        self.loaded = -1  # the owner's run whose inputs the buffers hold

    def release(self) -> None:
        """Under the device's ``lifecycle`` lock: the graph's last
        reference goes here, so its destructor runs here too."""
        graph, self.graph = self.graph, None
        self.gens, self.inputs, self.out, self.hist = [], {}, {}, None
        try:
            if graph is not None:
                graph.reset()
        finally:
            del graph


class _Device:
    """A device's captured graphs, least recently replayed first; its
    ``lock`` (the set), ``lifecycle`` lock (captures and releases),
    ``gate`` (replays), capture and replay streams and shared pool;
    ``bytes``: the graphs' buffers, ``pool_bytes``: the pool's;
    ``profilers``: those of :func:`start_profiler` recording."""

    def __init__(self, budget: int, stream=None, replay_stream=None,
                 pool=None):
        self.lock = threading.Lock()
        self.lifecycle = threading.Lock()
        self.gate = threading.Lock()
        self.stream = stream
        self.replay_stream = replay_stream
        self.pool = pool
        self.pool_bytes = 0
        self.profilers = 0
        self.graphs: "OrderedDict[tuple, _Graph]" = OrderedDict()
        self.bytes = 0
        self.budget = budget
        self.warm: set = set()  # keys this device has run eagerly
        # tokens of searches gone (appended by their finalizers, which may
        # run anywhere, this lock held included): dropped at the next visit
        self.gone: List[int] = []

    def take(self, token: int, key) -> Optional[_Graph]:
        with self.lock:
            dropped = self._drop_gone()
            g = self.graphs.get((token, key))
            if g is not None:
                self.graphs.move_to_end((token, key))
                g.busy = True
        self._release(dropped)
        return g

    def add(self, token: int, key, g: _Graph, pool_bytes: int = 0) -> None:
        """``pool_bytes``: the shared pool's size after ``g``'s capture."""
        with self.lock:
            dropped = self._drop_gone()
            g.busy = True
            self.graphs[(token, key)] = g
            self.bytes += g.bytes
            self.pool_bytes = pool_bytes
            dropped += self._evict()
        self._release(dropped)

    def settle(self, token: int) -> None:
        """A search's run is over: its graphs may be dropped."""
        with self.lock:
            dropped = self._drop_gone()
            for (t, _), g in self.graphs.items():
                if t == token:
                    g.busy = False
            dropped += self._evict()
        self._release(dropped)

    def _release(self, graphs: List[_Graph]) -> None:
        """Release ``graphs``; where none is left, later captures take a
        fresh pool (PyTorch shares a pool only while a graph holds it)."""
        if graphs:
            with self.lifecycle:
                for g in graphs:
                    g.release()
                self.renew()

    def renew(self) -> None:
        """Under ``lifecycle``: a fresh pool where no graph holds one."""
        with self.lock:
            if not self.graphs and self.pool is not None:
                self.pool = torch.cuda.graph_pool_handle()
                self.pool_bytes = 0

    def _drop_gone(self) -> List[_Graph]:
        dropped = []
        while self.gone:
            token = self.gone.pop()
            for k in [k for k in self.graphs if k[0] == token]:
                g = self.graphs.pop(k)
                self.bytes -= g.bytes
                dropped.append(g)
        return dropped

    def _evict(self) -> List[_Graph]:
        dropped = []
        for k in list(self.graphs):
            if self.bytes + self.pool_bytes <= self.budget:
                break
            g = self.graphs[k]
            if g.busy:
                continue
            del self.graphs[k]
            self.bytes -= g.bytes
            owner = g.owner()
            if owner is not None:
                owner.evictions += 1
            dropped.append(g)
        return dropped


_devices: Dict[torch.device, _Device] = {}
_devices_lock = threading.Lock()
_tokens = iter(range(1, 1 << 62))


def _indexed(dev) -> torch.device:
    """``dev`` with its index: ``cuda`` is the current card."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _device(dev: torch.device) -> _Device:
    dev = _indexed(dev)
    with _devices_lock:
        d = _devices.get(dev)
        if d is None:
            with torch.cuda.device(dev):
                d = _devices[dev] = _Device(
                    int(MEMORY_SHARE * torch.cuda.mem_get_info(dev)[1]),
                    torch.cuda.Stream(dev), torch.cuda.Stream(dev),
                    torch.cuda.graph_pool_handle())
        return d


def _profiling() -> bool:
    """Whether ``torch.profiler`` records in this process, from just
    before it starts until just after it stops (torch's own flag; there is
    no public one)."""
    return torch.autograd.profiler._is_profiler_enabled


def start_profiler(prof, device) -> None:
    """Start ``prof``, a ``torch.profiler.profile``, with the chunks on
    ``device`` replaying under it until :func:`stop_profiler`."""
    d = _device(device) if torch.device(device).type == "cuda" else None
    prof.start()
    if d is not None:
        with d.lock:
            d.profilers += 1


def stop_profiler(prof, device) -> None:
    """Stop a profiler :func:`start_profiler` started where no replay is
    in flight and no capture is under way on ``device`` (none starts
    meanwhile, and the card is synced first)."""
    if torch.device(device).type != "cuda":
        prof.stop()
        return
    d = _device(device)
    with d.gate, d.lifecycle:
        try:
            torch.cuda.synchronize(_indexed(device))
            prof.stop()
        finally:
            with d.lock:
                d.profilers -= 1


def _pool_bytes(pool) -> int:
    return sum(s["total_size"] for s in
               torch.cuda.memory_snapshot(mempool_id=pool))


def _reset_default_generator(stream: torch.cuda.Stream) -> None:
    """End the capture state a failed capture leaves on the device's
    default generator (its epilogue never ran, so its eager draws would
    raise): an empty capture runs the prologue and epilogue again."""
    empty = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream), warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # "graph is empty"
        empty.capture_begin(capture_error_mode="thread_local")
        empty.capture_end()


class ChunkGraphs:
    """One search's captured chunks, on its mesh's device, and its
    counts: ``captures`` (chunks captured, then replayed), ``replays``
    (chunks served by a graph captured before), ``fallbacks`` (chunks run
    eagerly: a key's first run on the device, under a profiler not started
    by :func:`start_profiler`, or after a failed capture),
    ``evictions`` (its graphs released for memory) and
    ``capture_seconds`` (this run's, the lifecycle lock's wait
    included)."""

    def __init__(self, mesh: IslandMesh):
        self.mesh = mesh
        self.captures = self.replays = self.fallbacks = self.evictions = 0
        self.capture_seconds = 0.0
        self.broken = False
        self._run = 0
        self._lent = False  # a chunk since own() replayed: see own()
        self._token = next(_tokens)
        self._dev = _device(mesh.device)
        weakref.finalize(self, self._dev.gone.append, self._token)

    def begin(self) -> None:
        """A run starts."""
        self._run += 1
        self.capture_seconds = 0.0

    def end(self) -> None:
        """A run is over (or failed): its graphs may be dropped."""
        self._dev.settle(self._token)

    def own(self, state: IslandState) -> IslandState:
        """``state`` in memory of its own where a chunk since the last
        call replayed (the state, or a part an eager chunk after it passed
        through, may lie in a graph's outputs)."""
        if not self._lent:
            return state
        self._lent = False
        t = [x.clone() for x in _state_tensors(state)]
        return _state_of(dict(zip(_STATE, t)), state.gen)

    def step(self, state: IslandState, generations: int, seed: int, traces,
             pairs, archive, failures, cfg, weights, novelty_scale=None,
             mutation_bias=None, coin=None, rings=()
             ) -> Tuple[IslandState, torch.Tensor]:
        """:func:`islands.fused_step` of a chunk on the search's mesh:
        ``(state, fit_hist)`` from the graph of the chunk's key (captured
        first where the search has none), or run eagerly (a key's first
        run on the device, under a profiler :func:`start_profiler` did not
        start, or after a failed capture). A replayed state
        lies in the graph's outputs until :meth:`own`."""
        if not self.broken and (self._dev.profilers or not _profiling()):
            inputs = dict(zip(_INPUTS, (*traces, pairs, archive, failures,
                                        coin, mutation_bias)))
            w_nov = weights.novelty * (1.0 if novelty_scale is None
                                       else novelty_scale)
            unit = weights._replace(novelty=1.0)  # w_nov is an input
            key = self._key(state, generations, inputs, cfg, unit, rings)
            g, fresh = self._dev.take(self._token, key), False
            if g is None and key in self._dev.warm:
                g = self._captured(key, state, generations, seed, inputs,
                                   cfg, unit, w_nov, rings)
                fresh = g is not None
            elif g is None:
                self._dev.warm.add(key)
            if g is not None:
                self.replays += not fresh
                self._lent = True
                return self._replay(g, state, generations, seed, inputs,
                                    w_nov, count=not fresh)
        self.fallbacks += 1
        return fused_step(state, generations, seed, traces, pairs, archive,
                          failures, cfg, weights,
                          novelty_scale=novelty_scale,
                          mutation_bias=mutation_bias, coin=coin,
                          mesh=self.mesh, rings=rings)

    def _key(self, state, generations, inputs, cfg, weights, rings) -> tuple:
        mesh = self.mesh
        plan = ring_plan(mesh, rings, state.pop.delays.shape[0]
                         // mesh.shards[0].islands, cfg)
        return (generations, mesh.axis_names, mesh.sizes,
                tuple(_sig(x) for x in _state_tensors(state)),
                tuple(_sig(inputs[n]) for n in _INPUTS), cfg, weights,
                tuple(plan), tuple(state.gen % every for *_, every in plan))

    def _captured(self, key, state, generations, seed, inputs, cfg,
                  weights, w_nov, rings) -> Optional[_Graph]:
        """The chunk captured and added to the device's set, or None where
        the capture failed (the search is then broken)."""
        t0 = time.perf_counter()
        try:
            g, pool = self._capture(state, generations, seed, inputs, cfg,
                                    weights, w_nov, rings)
        except Exception as e:
            self.broken = True
            log.warning("CUDA graph capture of the island step failed "
                        "(%s); this search runs eagerly from now on", e)
            return None
        finally:
            self.capture_seconds += time.perf_counter() - t0
        self._dev.add(self._token, key, g, pool)
        self.captures += 1
        return g

    def _load(self, g: _Graph, state: IslandState, inputs, w_nov) -> None:
        for name, x in zip(_STATE, _state_tensors(state)):
            g.inputs[name].copy_(x)
        if g.loaded != self._run:
            for name in _INPUTS:
                if inputs[name] is not None:
                    g.inputs[name].copy_(inputs[name])
            g.inputs["novelty"].fill_(w_nov)
            g.loaded = self._run

    def _capture(self, state, generations, seed, inputs, cfg, weights,
                 w_nov, rings) -> Tuple[_Graph, int]:
        """The chunk's graph, and the shared pool's bytes after it."""
        dev, mesh = self._dev, self.mesh
        g = _Graph(self)
        g.inputs = {n: torch.empty_like(x) for n, x in
                    zip(_STATE, _state_tensors(state))}
        g.inputs.update({n: None if inputs[n] is None else
                         torch.empty_like(inputs[n]) for n in _INPUTS})
        g.inputs["novelty"] = torch.empty((), device=mesh.device)
        g.out = {n: torch.empty_like(x) for n, x in
                 zip(_STATE, _state_tensors(state))}
        g.hist = torch.empty(generations, dtype=state.best_fitness.dtype,
                             device=mesh.device)
        self._load(g, state, inputs, w_nov)
        i = g.inputs
        traces = TraceArrays(i["hint_ids"], i["arrival"], i["mask"],
                             i["faultable"])
        cur = torch.cuda.current_stream(mesh.device)
        with dev.lifecycle:
            g.graph = torch.cuda.CUDAGraph()
            g.gens = [[torch.Generator(device=mesh.device)
                       for _ in range(mesh.shards[0].islands)]
                      for _ in range(generations)]
            for row in g.gens:
                for gen in row:
                    g.graph.register_generator_state(gen)
            dev.stream.wait_stream(cur)
            before = pair_distance.thread_launches()
            with torch.cuda.stream(dev.stream):
                began = ended = False
                try:
                    g.graph.capture_begin(pool=dev.pool,
                                          capture_error_mode="thread_local")
                    began = True
                    out, hist = fused_step(
                        _state_of(i, state.gen), generations, seed, traces,
                        i["pairs"], i["archive"], i["failures"], cfg,
                        weights, novelty_scale=i["novelty"],
                        mutation_bias=i["bias"], coin=i["coin"], mesh=mesh,
                        rings=rings, gens=[[row] for row in g.gens])
                    for name, x in zip(_STATE, _state_tensors(out)):
                        g.out[name].copy_(x)
                    g.hist.copy_(hist)
                    del out, hist  # temporaries, as all the pool holds
                    ended = True
                    g.graph.capture_end()
                except BaseException:
                    if began and not ended:
                        try:
                            g.graph.capture_end()
                        except Exception:
                            pass  # the capture's own error is raised
                    g.release()
                    dev.renew()
                    _reset_default_generator(dev.stream)
                    raise
            cur.wait_stream(dev.stream)
            after = pair_distance.thread_launches()
            pool = _pool_bytes(dev.pool)
        g.launches = (after[0] - before[0], after[1] - before[1])
        g.bytes = sum(x.numel() * x.element_size() for x in
                      (*g.inputs.values(), *g.out.values(), g.hist)
                      if x is not None)
        return g, pool

    def _replay(self, g: _Graph, state: IslandState, generations: int,
                seed: int, inputs, w_nov, count: bool
                ) -> Tuple[IslandState, torch.Tensor]:
        """Replay ``g`` on ``state``; ``count``: add its launches (a
        capture counted them for the chunk it serves)."""
        self._load(g, state, inputs, w_nov)
        for row, seeds in zip(g.gens, chunk_seeds(seed, state.gen,
                                                  generations, self.mesh)):
            for gen, s in zip(row, seeds):
                gen.manual_seed(s)
        dev = self._dev
        cur = torch.cuda.current_stream(self.mesh.device)
        with dev.gate:
            dev.replay_stream.wait_stream(cur)
            with torch.cuda.stream(dev.replay_stream):
                g.graph.replay()
            cur.wait_stream(dev.replay_stream)
        if count:
            pair_distance.LAUNCHES += g.launches[0]
            pair_distance.SINGLE_LAUNCHES += g.launches[1]
        return _state_of(g.out, state.gen + generations), g.hist
