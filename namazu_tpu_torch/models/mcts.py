"""Monte-Carlo tree search over schedule genomes: the port of
``namazu_tpu/models/mcts.py`` (BASELINE config 5).

The genome is sequentialised: hint buckets are ordered by importance
(frequency in the reference traces), each tree level picks one of ``D``
quantised delay levels for the next bucket, and a leaf's value is the
mean fitness of ``R`` random completions of the remaining buckets, scored
by the GA's own scorer (``ops/schedule.py``). One simulation is select
(descent by normalised UCT) -> expand (one node) -> rollout -> backprop.

Design on the card. The tree is ``simulations + 1`` nodes by ``n_levels``
children (257 x 8 at the policy's defaults) and lives on the host in
numpy, in f32 as in the reference: selection and backprop are a few
dozen small numpy steps a simulation. The rollout runs on the card: the
``[R, H]`` delay and fault draws, the seeded rows, the tree-pinned
buckets, and ``score_population_multi`` over the ``R * T`` feature rows,
which launches the pair-distance kernel (B1) once. Each simulation reads
one number back, the rollout's mean, which the next selection needs; the
best table stays on the card.

Root-parallel trees (the reference's ``make_parallel_mcts``): one tree an
island of the mesh. The trees of one shard advance in lockstep
(:func:`mcts_search_trees`): every tree's selection and expansion on the
host, then one batch of ``I * R`` rollout rows scored in one call and one
sync for all I means, so one simulation of I trees costs about what one
tree's does.

Random numbers: the reference splits a ``jax.random`` key per
simulation; here simulation ``i`` of a tree seeded ``seed`` draws from a
``torch.Generator`` seeded from ``(seed, i)``, and the tree at mesh
coordinates ``c`` of a search seeded ``s`` is seeded ``fold_coords(s,
c)``. :class:`RolloutDraws` is the draws-in form, so a test can hand in
the reference's own draws.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from namazu_tpu_torch.ops.schedule import (
    ScoreWeights,
    TraceArrays,
    normalize_fault_trace,
    score_population_multi,
)
from namazu_tpu_torch.parallel.islands import (
    fold_coords,
    generator_for,
    global_best,
    replicate,
)
from namazu_tpu_torch.parallel.mesh import IslandMesh

NO_CHILD = -1


class MCTSConfig(NamedTuple):
    tree_depth: int = 24  # buckets decided by the tree (most important first)
    n_levels: int = 8  # quantised delay levels per bucket
    simulations: int = 256  # tree expansions per search call
    rollouts: int = 64  # random completions scored per leaf (one batch)
    c_uct: float = 1.25  # exploration constant (on [0,1]-normalised values)
    max_delay: float = 0.1  # seconds; level j = j/(D-1) * max_delay
    max_fault: float = 0.0  # rollout fault-probability cap (0 = off)


class Tree(NamedTuple):
    """Fixed-capacity search tree on the host, N = simulations + 1 nodes.
    The arrays are updated in place; ``n_nodes`` by ``_replace``."""

    parent: np.ndarray  # int32[N]
    action: np.ndarray  # int32[N] level chosen on the edge into the node
    depth: np.ndarray  # int32[N] root = 0
    children: np.ndarray  # int32[N, D], NO_CHILD where unexpanded
    visit: np.ndarray  # f32[N]
    value_sum: np.ndarray  # f32[N]
    n_nodes: int


class MCTSResult(NamedTuple):
    best_fitness: torch.Tensor  # f32 scalar, on the search's device
    best_delays: torch.Tensor  # f32[H]
    best_faults: torch.Tensor  # f32[H]
    tree_visits: np.ndarray  # f32[N] (diagnostics: visit counts)
    root_child_visits: np.ndarray  # f32[D] (diagnostics)
    tree: Tree  # the whole tree (the reference returns only its visits)


class RolloutDraws(NamedTuple):
    """Every random number one simulation's rollouts consume, for I trees
    advanced in lockstep."""

    delays: torch.Tensor  # f32[I, R, H] uniform in [0, max_delay)
    faults: torch.Tensor  # f32[I, R, H] uniform in [0, max_fault)
    noise: torch.Tensor  # f32[I, n_seeded_rows, H] standard normals


def init_tree(cfg: MCTSConfig) -> Tree:
    N, D = cfg.simulations + 1, cfg.n_levels
    return Tree(
        parent=np.full((N,), NO_CHILD, np.int32),
        action=np.full((N,), NO_CHILD, np.int32),
        depth=np.zeros((N,), np.int32),
        children=np.full((N, D), NO_CHILD, np.int32),
        visit=np.zeros((N,), np.float32),
        value_sum=np.zeros((N,), np.float32),
        n_nodes=1,  # node 0 = root
    )


def level_values(cfg: MCTSConfig) -> np.ndarray:
    """The delay of each level, ``f32[D]``, rounded as the reference's
    ``jnp.linspace(0.0, max_delay, D)`` comes out of XLA in f32: level
    ``j`` is ``j * (max_delay * (1 / (D - 1)))`` (XLA folds the two
    constants first), the last level exactly ``max_delay``."""
    D = cfg.n_levels
    if D == 1:
        return np.zeros((1,), np.float32)
    f32 = np.float32
    step = f32(cfg.max_delay) * (f32(1.0) / f32(D - 1))
    return np.append(np.arange(D - 1, dtype=f32) * step,
                     f32(cfg.max_delay)).astype(f32)


def n_seeded_rows(cfg: MCTSConfig, n_seeds: int) -> int:
    """Rollout rows completed from a demonstration table: up to half."""
    return min(cfg.rollouts // 2, max(0, n_seeds * 4))


def _ucb_scores(tree: Tree, node: int, vmin: np.float32, vmax: np.float32,
                c: float) -> np.ndarray:
    """Normalised-UCT score per child slot, in f32; unexpanded slots get
    +inf so every action is tried once before any is revisited."""
    kids = tree.children[node]
    safe = np.maximum(kids, 0)
    v = tree.visit[safe]
    one = np.float32(1.0)
    with np.errstate(invalid="ignore", over="ignore", divide="ignore"):
        q = tree.value_sum[safe] / np.maximum(v, one)
        # until two distinct values exist (vmax == vmin, or still
        # +-inf), visited children tie at 0.5 and exploration decides
        denom = np.float32(vmax - vmin)
        q01 = np.where(denom > np.float32(1e-9),
                       (q - vmin) / np.maximum(denom, np.float32(1e-9)),
                       np.float32(0.5)).astype(np.float32)
        q01 = np.where(np.isfinite(q01), q01, np.float32(0.5))
        explore = np.float32(c) * np.sqrt(
            np.log(tree.visit[node] + one) / np.maximum(v, one))
    return np.where(kids == NO_CHILD, np.float32(np.inf),
                    (q01 + explore).astype(np.float32))


def draw_rollouts(gens, cfg: MCTSConfig, H: int,
                  n_seeded: int) -> RolloutDraws:
    """One simulation's draws for I trees, tree ``i`` from ``gens[i]``
    (on the generators' device): its delays, faults, then noise."""
    dev = gens[0].device
    I, R = len(gens), cfg.rollouts
    d = torch.empty((I, R, H), device=dev)
    f = torch.empty((I, R, H), device=dev)
    noise = torch.empty((I, n_seeded, H), device=dev)
    for i, g in enumerate(gens):
        torch.rand((R, H), generator=g, out=d[i])
        torch.rand((R, H), generator=g, out=f[i])
        torch.randn((n_seeded, H), generator=g, out=noise[i])
    return RolloutDraws(d * cfg.max_delay, f * cfg.max_fault, noise)


def _make_rollout(trace: TraceArrays, pairs, archive, failure_feats,
                  hint_order, values, H: int, cfg: MCTSConfig,
                  weights: ScoreWeights, coin=None, seeds=None,
                  tree_seeds: Sequence[int] = (0,)):
    """Returns ``rollout(sim, levels int32[I, tree_depth], draws=None) ->
    (mean fitness [I], best fitness [I], best delays [I, H], best faults
    [I, H])``, device tensors, for the I trees of ``tree_seeds``: their
    ``I * R`` rollout rows are scored in one call (one launch of the
    pair-distance kernel). Without ``draws`` tree ``i``'s simulation
    ``sim`` draws from the generator of ``(tree_seeds[i], sim)``.

    With ``cfg.max_fault > 0`` and a ``coin`` the random fault tables are
    scored, so the returned fault table is selected, not a draw.
    ``seeds f32[S, H]`` (S may be 0) are demonstration tables: up to half
    of each tree's rows complete the unpinned buckets from a
    noise-perturbed seed."""
    device = archive.device
    n_seeds = 0 if seeds is None else seeds.shape[0]
    n_seeded = n_seeded_rows(cfg, n_seeds)
    rep = None
    if n_seeded > 0:
        rep = seeds.repeat(-(-n_seeded // n_seeds), 1)[:n_seeded]
    order = np.asarray(hint_order, np.int64)
    score_faults = cfg.max_fault > 0 and coin is not None
    R = cfg.rollouts

    def rollout(sim: int, levels: np.ndarray,
                draws: Optional[RolloutDraws] = None):
        I = levels.shape[0]
        if draws is None:
            draws = draw_rollouts([generator_for(t, sim, device)
                                   for t in tree_seeds], cfg, H, n_seeded)
        delays = draws.delays
        if n_seeded > 0:
            seeded = torch.clamp(
                rep + draws.noise * (0.05 * cfg.max_delay), 0.0,
                cfg.max_delay)
            delays = torch.cat([seeded, delays[:, n_seeded:]], dim=1)
        # pin the tree-assigned buckets: values and flags built on the
        # host, one asynchronous copy to the card from pinned memory
        val = np.zeros((I, H), np.float32)
        on = np.zeros((I, H), np.float32)
        val[:, order] = values[np.maximum(levels, 0)]
        on[:, order] = levels >= 0
        pin = torch.from_numpy(np.stack([val, on])[:, :, None])
        if device.type == "cuda":
            pin = pin.pin_memory().to(device, non_blocking=True)
        delays = torch.where(pin[1] > 0, pin[0], delays)
        fitness, _ = score_population_multi(
            delays.reshape(I * R, H), trace, pairs, archive, failure_feats,
            weights,
            faults=draws.faults.reshape(I * R, H) if score_faults else None,
            coin=coin)
        fitness = fitness.view(I, R)
        b = fitness.argmax(-1, keepdim=True)  # [I, 1]
        rows = b[..., None].expand(I, 1, H)
        return (fitness.mean(-1), fitness.gather(-1, b).squeeze(-1),
                delays.gather(1, rows).squeeze(1),
                draws.faults.gather(1, rows).squeeze(1))

    return rollout


def _select_expand(tree: Tree, vmin, vmax, cfg: MCTSConfig):
    """Selection (descent by UCT until an unexpanded slot or maximum
    depth) and expansion (one node, none at a leaf of maximum depth):
    ``(tree, levels int32[tree_depth], leaf)``."""
    Td = cfg.tree_depth
    node, act = 0, NO_CHILD
    levels = np.full((Td,), NO_CHILD, np.int32)
    while tree.depth[node] < Td:
        a = int(np.argmax(_ucb_scores(tree, node, vmin, vmax, cfg.c_uct)))
        levels[tree.depth[node]] = a
        child = int(tree.children[node, a])
        if child == NO_CHILD:
            act = a
            break
        node = child
    leaf = node
    if act != NO_CHILD:
        leaf = tree.n_nodes
        tree.parent[leaf] = node
        tree.action[leaf] = act
        tree.depth[leaf] = tree.depth[node] + 1
        tree.children[node, act] = leaf
        tree = tree._replace(n_nodes=leaf + 1)
    return tree, levels, leaf


def _backprop(tree: Tree, leaf: int, value: np.float32) -> None:
    n = leaf
    while n != NO_CHILD:
        tree.visit[n] += np.float32(1.0)
        tree.value_sum[n] += value
        n = int(tree.parent[n])


def mcts_search_trees(
    tree_seeds: Sequence[int],
    trace: TraceArrays,  # stacked [T, L] (or one [L] trace)
    pairs: torch.Tensor,  # [K, 2]
    archive: torch.Tensor,  # f32[A, K]
    failure_feats: torch.Tensor,  # f32[F, K]
    hint_order,  # int[tree_depth] bucket ids, important first
    H: int,
    cfg: MCTSConfig = MCTSConfig(),
    weights: ScoreWeights = ScoreWeights(),
    coin: Optional[torch.Tensor] = None,  # f32[H] fault coin
    seeds: Optional[torch.Tensor] = None,  # f32[S, H] demonstrations
) -> List[MCTSResult]:
    """One full search of ``cfg.simulations`` simulations for each of the
    independent trees of ``tree_seeds``, on the device of ``archive``,
    advanced in lockstep: a simulation selects and expands every tree on
    the host, scores all the trees' rollouts in one batch, and reads
    their means back in one sync. Tree ``i`` grows exactly as a search of
    its own seed alone."""
    if coin is None and cfg.max_fault > 0:
        raise ValueError(
            "fault search is enabled (max_fault > 0) but no fault coin "
            "was passed; build one with trace_encoding.fault_coin(seed, H)")
    if trace.hint_ids.dim() == 1:
        trace = TraceArrays(*(None if x is None else x[None] for x in trace))
    trace = normalize_fault_trace(trace, coin)
    if torch.is_tensor(hint_order):
        hint_order = hint_order.cpu().numpy()
    I = len(tree_seeds)
    rollout = _make_rollout(trace, pairs, archive, failure_feats,
                            hint_order, level_values(cfg), H, cfg, weights,
                            coin=coin, seeds=seeds, tree_seeds=tree_seeds)
    trees = [init_tree(cfg) for _ in range(I)]
    vmin = np.full((I,), np.inf, np.float32)
    vmax = np.full((I,), -np.inf, np.float32)
    device = archive.device
    best_fit = torch.full((I,), float("-inf"), device=device)
    best_d = torch.zeros((I, H), device=device)
    best_f = torch.zeros((I, H), device=device)
    levels = np.empty((I, cfg.tree_depth), np.int32)
    leaves = [0] * I
    for sim in range(cfg.simulations):
        for i in range(I):
            trees[i], levels[i], leaves[i] = _select_expand(
                trees[i], vmin[i], vmax[i], cfg)
        mean_t, roll_fit, roll_d, roll_f = rollout(sim, levels)
        means = mean_t.cpu().numpy()  # the simulation's one sync
        for i in range(I):
            mean_v = np.float32(means[i])
            _backprop(trees[i], leaves[i], mean_v)
            vmin[i], vmax[i] = min(vmin[i], mean_v), max(vmax[i], mean_v)
        improved = roll_fit > best_fit
        best_fit = torch.where(improved, roll_fit, best_fit)
        best_d = torch.where(improved[:, None], roll_d, best_d)
        best_f = torch.where(improved[:, None], roll_f, best_f)
    out = []
    for i, tree in enumerate(trees):
        root = tree.children[0]
        out.append(MCTSResult(
            best_fitness=best_fit[i],
            best_delays=best_d[i],
            best_faults=best_f[i],
            tree_visits=tree.visit.copy(),
            root_child_visits=tree.visit[np.maximum(root, 0)]
            * (root != NO_CHILD),
            tree=tree,
        ))
    return out


def mcts_search(seed: int, trace: TraceArrays, pairs: torch.Tensor,
                archive: torch.Tensor, failure_feats: torch.Tensor,
                hint_order, H: int, cfg: MCTSConfig = MCTSConfig(),
                weights: ScoreWeights = ScoreWeights(),
                coin: Optional[torch.Tensor] = None,
                seeds: Optional[torch.Tensor] = None) -> MCTSResult:
    """One full search of ``cfg.simulations`` simulations on the device
    of ``archive``; the same inputs and ``seed`` give the same result."""
    return mcts_search_trees([seed], trace, pairs, archive, failure_feats,
                             hint_order, H, cfg, weights, coin=coin,
                             seeds=seeds)[0]


def parallel_mcts(seed: int, mesh: IslandMesh, trace: TraceArrays,
                  pairs: torch.Tensor, archive: torch.Tensor,
                  failure_feats: torch.Tensor, hint_order, H: int,
                  cfg: MCTSConfig = MCTSConfig(),
                  weights: ScoreWeights = ScoreWeights(),
                  coin: Optional[torch.Tensor] = None,
                  seeds: Optional[torch.Tensor] = None):
    """Root-parallel MCTS, the port of the reference's
    ``make_parallel_mcts``: one tree per island of ``mesh``, the tree at
    coordinates ``c`` seeded from ``(seed, c)`` (all-zero coordinates:
    ``seed`` itself), each shard's trees in lockstep on its device (the
    shards one after another), then the row-major argmax of the trees'
    bests, the first tree on ties, gathered across processes on a
    distributed mesh. Returns ``(fitness, delays, faults)`` on the
    primary device."""
    inputs = replicate(mesh, trace, pairs, archive, failure_feats, coin,
                       seeds)
    cands = []
    for sh in mesh.shards:
        tr, pr, ar, fl, cn, sd = inputs[sh.device]
        res = mcts_search_trees(
            [fold_coords(seed, mesh.coords(g))
             for g in range(sh.start, sh.start + sh.islands)],
            tr, pr, ar, fl, hint_order, H, cfg, weights, coin=cn, seeds=sd)
        fits = torch.stack([r.best_fitness for r in res])
        j = fits.argmax()
        cands.append((fits[j], torch.stack([r.best_delays for r in res])[j],
                      torch.stack([r.best_faults for r in res])[j]))
    return global_best(cands, mesh)
