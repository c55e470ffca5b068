"""The port's min squared distances (namazu_tpu_torch/ops/pair_distance.py:
B1 the pair, B2 the single archive) held to the reference's Pallas
kernels (interpret mode) and to its plain XLA distances.

On CPU tensors the wrapper runs its plain PyTorch version; the CUDA
kernel itself is held to that version on the card by chip_smoke.py.
Tolerance: rtol 1e-3 / atol 1e-4, the tolerance tests/test_pallas_score.py
applies to the Pallas kernel (f32 sums taken in another order)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from namazu_tpu.ops import schedule as jsched
from namazu_tpu.ops.pallas_score import (
    min_sq_distance_pair_pallas,
    min_sq_distance_pallas,
)
from namazu_tpu_torch.ops import pair_distance as pd
from namazu_tpu_torch.ops import schedule as tsched

RTOL, ATOL = 1e-3, 1e-4
SHAPES = [(64, 32, 16, 128), (300, 100, 7, 128), (33, 7, 5, 64)]


def make_inputs(N, A, F, K, seed=0):
    rng = np.random.RandomState(seed)
    feats = rng.rand(N, K).astype(np.float32)
    archive = rng.rand(A, K).astype(np.float32)
    failures = rng.rand(F, K).astype(np.float32)
    return feats, archive, failures


def port(feats, archive, failures, **kw):
    nov, bug = pd.min_sq_distance_pair(torch.from_numpy(feats),
                                       torch.from_numpy(archive),
                                       torch.from_numpy(failures), **kw)
    return nov.numpy(), bug.numpy()


@pytest.mark.parametrize("occupied", [False, True])
@pytest.mark.parametrize("N,A,F,K", SHAPES)
def test_pair_matches_pallas_interpret(N, A, F, K, occupied):
    feats, archive, failures = make_inputs(N, A, F, K)
    occ = {}
    if occupied:  # occupancies below capacity
        occ = {"archive_n": max(1, A // 2), "failure_n": max(1, F - 2)}
    want_nov, want_bug = min_sq_distance_pair_pallas(
        jnp.asarray(feats), jnp.asarray(archive), jnp.asarray(failures),
        tile_p=32, tile_a=16, interpret=True,
        **{k: jnp.asarray(v, jnp.int32) for k, v in occ.items()})
    nov, bug = port(feats, archive, failures, **occ)
    assert nov.shape == (N,) and bug.shape == (N,)
    np.testing.assert_allclose(nov, np.asarray(want_nov), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(bug, np.asarray(want_bug), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("N,A,F,K", SHAPES)
def test_pair_matches_xla_min_sq_distance(N, A, F, K):
    feats, archive, failures = make_inputs(N, A, F, K, seed=1)
    nov, bug = port(feats, archive, failures, archive_n=A - 1,
                    failure_n=torch.tensor(F))
    f = jnp.asarray(feats)
    want_nov = jsched.min_sq_distance(f, jnp.asarray(archive),
                                      valid_n=jnp.asarray(A - 1))
    want_bug = jsched.min_sq_distance(f, jnp.asarray(failures))
    np.testing.assert_allclose(nov, np.asarray(want_nov), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(bug, np.asarray(want_bug), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("archive_n,failure_n", [(0, 0), (0, 3), (5, 0)])
def test_zero_occupancy_is_neutral_through_min_sq_pair_best(archive_n,
                                                            failure_n):
    feats, archive, failures = make_inputs(40, 9, 6, 64, seed=2)
    want = jsched._min_sq_pair_best(
        jnp.asarray(feats), jnp.asarray(archive), jnp.asarray(failures),
        archive_n=jnp.asarray(archive_n, jnp.int32),
        failure_n=jnp.asarray(failure_n, jnp.int32))
    got = tsched._min_sq_pair_best(
        torch.from_numpy(feats), torch.from_numpy(archive),
        torch.from_numpy(failures), archive_n=torch.tensor(archive_n),
        failure_n=failure_n)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)
    if archive_n == 0:
        assert np.all(got[0].numpy() == 0.0)
    if failure_n == 0:
        assert np.all(got[1].numpy() == 0.0)


@pytest.mark.parametrize("empty", ["archive", "failures"])
def test_empty_buffer_raises(empty):
    feats, archive, failures = make_inputs(8, 4, 4, 16)
    if empty == "archive":
        archive = archive[:0]
    else:
        failures = failures[:0]
    with pytest.raises(ValueError, match="empty archive/failures"):
        port(feats, archive, failures)


def test_reference_matches_brute_force():
    feats, archive, failures = make_inputs(50, 13, 4, 32, seed=4)
    nov, bug = port(feats, archive, failures, archive_n=10)
    d_a = ((feats[:, None] - archive[None, :10]) ** 2).sum(-1).min(1)
    d_f = ((feats[:, None] - failures[None]) ** 2).sum(-1).min(1)
    np.testing.assert_allclose(nov, d_a, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(bug, d_f, rtol=RTOL, atol=ATOL)


def test_launch_count_stays_zero_on_cpu():
    before = pd.LAUNCHES
    feats, archive, failures = make_inputs(16, 4, 4, 16)
    port(feats, archive, failures)
    tsched.min_sq_distance(torch.from_numpy(feats), torch.from_numpy(archive))
    assert pd.LAUNCHES == before == 0
    assert pd.SINGLE_LAUNCHES == 0


# -- the kernel's grid plan and its split of the column walk ----------------
#
# The card's launch is planned on the host (pair_distance.grid_plan): where
# the feature tiles leave SMs idle, a cluster of ranks splits the column
# tiles and rank 0 takes the min of the ranks' minima. The kernel runs only
# on the card; here the plan is checked, and the split is emulated on the
# plain version's distances: per-rank minima over each rank's tiles, then
# their min, which must equal the unsplit min bit for bit (min is exact).

H100_SMS = 132
MAIN, BENCH = (16384, 512, 64, 256), (8192, 1024, 64, 256)
ROLLOUTS = [(256, 512, 64, 256), (64, 512, 64, 256)]
TREES = (2048, 512, 64, 256)  # 8 lockstep MCTS trees x 64 rollouts x 4
PLAN_SHAPES = [MAIN, BENCH, *ROLLOUTS, TREES, *SHAPES, (1, 512, 64, 256),
               (1, 1, 1, 64)]


def column_tiles(A, F):
    return -(-A // pd.BN), -(-F // pd.BN)


@pytest.mark.parametrize("N,A,F,K", PLAN_SHAPES)
def test_grid_plan_splits_every_column_tile_once(N, A, F, K):
    plan = pd.grid_plan(N, A, F, K, H100_SMS)
    ta, tf = column_tiles(A, F)
    owned = [t for lo, hi in plan.ranges for t in range(lo, hi)]
    assert owned == list(range(ta + tf))  # each tile once, contiguous
    assert len(plan.ranges) == plan.split and all(
        hi > lo for lo, hi in plan.ranges)
    assert 1 <= plan.split <= min(pd.MAX_SPLIT, ta + tf)
    assert plan.split & (plan.split - 1) == 0  # a power-of-two cluster
    assert plan.bm in (64, 128)
    assert plan.row_tiles == -(-N // plan.bm)
    busiest = max(hi - lo for lo, hi in plan.ranges)
    assert plan.steps == busiest * -(-K // pd.BK)
    # one wave: every block runs at once; of the splits that stay one wave,
    # none walks fewer tiles a rank, and none smaller walks as few
    assert plan.blocks <= H100_SMS or plan.split == 1
    for s in (1, 2, 4, 8):
        if s <= min(pd.MAX_SPLIT, ta + tf) and plan.row_tiles * s <= \
                H100_SMS:
            assert -(-(ta + tf) // s) >= busiest
            if s < plan.split:
                assert -(-(ta + tf) // s) > busiest


def critical_steps(plan):
    return plan.waves * plan.steps


@pytest.mark.parametrize("N,A,F,K", PLAN_SHAPES)
def test_grid_plan_takes_the_block_height_of_the_shorter_critical_path(
        N, A, F, K):
    plan = pd.grid_plan(N, A, F, K, H100_SMS)
    other = pd._plan(N, A, F, K, H100_SMS, 3 - plan.consumers)
    assert critical_steps(plan) < critical_steps(other) or (
        critical_steps(plan) == critical_steps(other) and plan.bm == 64)


def test_grid_plan_at_the_timed_shapes():
    main = pd.grid_plan(*MAIN, H100_SMS)
    assert (main.bm, main.row_tiles, main.split, main.blocks,
            main.steps) == (128, 128, 1, 128, 72)  # no split: one wave
    bench = pd.grid_plan(*BENCH, H100_SMS)
    assert (bench.bm, bench.row_tiles, bench.split, bench.blocks,
            bench.steps) == (128, 64, 2, 128, 72)
    for N, rows in ((256, 4), (64, 1)):
        p = pd.grid_plan(N, 512, 64, 256, H100_SMS)
        assert (p.bm, p.row_tiles, p.split, p.steps) == (64, rows, 8, 16)
    single = pd.grid_plan(16384, 512, 0, 256, H100_SMS)  # B2's main shape
    assert (single.bm, single.split, single.steps) == (128, 1, 64)


def test_grid_plan_keeps_to_the_clusters_the_card_holds_at_once():
    """An H100 holds 15 clusters of 8 such blocks at once, not 132 / 8: 16
    row tiles split 8 ways would take two waves, so the plan splits less
    (or holds more rows a block, or fewer) and stays one wave."""
    free = pd.grid_plan(*TREES, H100_SMS)
    assert (free.bm, free.split, free.waves) == (128, 8, 1)
    h100 = pd.grid_plan(*TREES, H100_SMS, ((1, 8, 15), (2, 8, 15)))
    assert h100.waves == 1 and h100.split < 8
    assert critical_steps(h100) == 24  # 3 column tiles a rank
    assert free.row_tiles > 15  # its 16 clusters of 8: two waves there


def test_grid_plan_falls_back_to_one_warpgroup_for_wide_rows():
    assert pd.grid_plan(4096, 200, 9, 512, H100_SMS).bm == 64
    with pytest.raises(ValueError, match="does not fit"):
        pd.grid_plan(64, 8, 8, 1024, H100_SMS)


def split_emulation(feats, archive, failures, an, fn, plan):
    """B1 as the split grid computes it: each rank's minima over its own
    column tiles (+inf for a segment it has none of), then the min over
    the ranks, clamped at 0."""
    d = (pd._sq_distances(feats, archive, an),
         pd._sq_distances(feats, failures, fn))
    ta = column_tiles(archive.shape[0], failures.shape[0])[0]
    N = feats.shape[0]
    ranks = []
    for lo, hi in plan.ranges:
        mins = [torch.full((N,), float("inf")) for _ in range(2)]
        for t in range(lo, hi):
            seg, j = (0, t) if t < ta else (1, t - ta)
            cols = d[seg][:, j * pd.BN:(j + 1) * pd.BN]
            mins[seg] = torch.minimum(mins[seg], cols.amin(-1))
        ranks.append(mins)
    return tuple(torch.stack([r[s] for r in ranks]).amin(0).clamp_min(0.0)
                 for s in range(2))


SPLIT_OCCUPANCIES = [(None, None), (300, 17), (1, 0), (0, 64)]


@pytest.mark.parametrize("an,fn", SPLIT_OCCUPANCIES)
@pytest.mark.parametrize("N,A,F,K", [BENCH[:1] + (520, 64, 32),
                                     *ROLLOUTS, *SHAPES, (1, 1, 1, 64)])
def test_split_emulation_equals_the_plain_version_bitwise(N, A, F, K, an,
                                                          fn):
    feats, archive, failures = (torch.from_numpy(x) for x in make_inputs(
        N, A, F, K, seed=7))
    an = None if an is None else min(an, A)
    fn = None if fn is None else min(fn, F)
    plan = pd.grid_plan(N, A, F, K, H100_SMS)
    assert plan.split > 1
    got = split_emulation(feats, archive, failures, an, fn, plan)
    want = pd.min_sq_distance_pair_reference(feats, archive, failures, an,
                                             fn)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("occupied", [False, True])
@pytest.mark.parametrize("N", [64, 256])
def test_port_matches_the_reference_at_the_mcts_rollout_shapes(N,
                                                               occupied):
    """B1 at what an MCTS rollout hands it (64 rollouts x 4 traces, or one
    trace): the port's dispatch point against the reference's; at N = 64
    also against the Pallas kernel in interpret mode."""
    feats, archive, failures = make_inputs(N, 512, 64, 256, seed=8)
    an, fn = (300, 17) if occupied else (None, None)
    j = {} if not occupied else {"archive_n": jnp.asarray(an, jnp.int32),
                                 "failure_n": jnp.asarray(fn, jnp.int32)}
    f, a, g = (jnp.asarray(x) for x in (feats, archive, failures))
    want = [jsched._min_sq_pair_best(f, a, g, **j)]
    if N == 64:
        want.append(min_sq_distance_pair_pallas(
            f, a, g, tile_p=64, tile_a=64, interpret=True, **j))
    got = tsched._min_sq_pair_best(
        torch.from_numpy(feats), torch.from_numpy(archive),
        torch.from_numpy(failures),
        archive_n=None if an is None else torch.tensor(an, dtype=torch.int32),
        failure_n=fn)
    for w in want:
        for x, y in zip(got, w):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=RTOL,
                                       atol=ATOL)


@pytest.mark.parametrize("n,want", [(None, (None, 9)), (5, (None, 5)),
                                    ("cpu", (None, 7))])
def test_occupancies_go_by_value_without_a_tensor_op(n, want):
    if n == "cpu":
        n = torch.tensor(7)
    assert pd._occupancy(n, 9, torch.device("cpu")) == want


def test_occupancy_must_be_one_int():
    with pytest.raises(ValueError, match="one int"):
        pd._occupancy(torch.tensor([1, 2]), 9, torch.device("cpu"))


# -- B2: one archive, masked by valid_n ------------------------------------

SINGLE_SHAPES = [(64, 32, 128), (300, 100, 128), (33, 7, 64)]


@pytest.mark.parametrize("valid_n", [None, 0, 1, "half"])
@pytest.mark.parametrize("N,A,K", SINGLE_SHAPES)
def test_single_matches_pallas_interpret_and_xla(N, A, K, valid_n):
    feats, archive, _ = make_inputs(N, A, 1, K, seed=5)
    n = max(1, A // 2) if valid_n == "half" else valid_n
    jn = None if n is None else jnp.asarray(n, jnp.int32)
    f, a = jnp.asarray(feats), jnp.asarray(archive)
    want_pallas = np.asarray(min_sq_distance_pallas(
        f, a, tile_p=32, tile_a=16, interpret=True, valid_n=jn))
    want_xla = np.asarray(jsched.min_sq_distance(f, a, valid_n=jn))
    tf, ta = torch.from_numpy(feats), torch.from_numpy(archive)
    for fn in (tsched.min_sq_distance, tsched._min_sq_distance_best,
               pd.min_sq_distance, pd.min_sq_distance_reference):
        occ = n if fn is not tsched._min_sq_distance_best \
            else (None if n is None else torch.tensor(n))
        got = fn(tf, ta, occ).numpy()
        assert got.shape == (N,)
        np.testing.assert_allclose(got, want_pallas, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got, want_xla, rtol=RTOL, atol=ATOL)
    if n == 0:  # nothing live: the mask identity, as in the reference
        assert np.all(got > 1e38)


def test_single_is_the_pair_kernels_first_segment():
    feats, archive, failures = make_inputs(50, 13, 4, 32, seed=6)
    tf, ta, tg = (torch.from_numpy(x) for x in (feats, archive, failures))
    nov, _ = pd.min_sq_distance_pair(tf, ta, tg, archive_n=9)
    assert torch.equal(pd.min_sq_distance(tf, ta, 9), nov)
    d = ((feats[:, None] - archive[None, :9]) ** 2).sum(-1).min(1)
    np.testing.assert_allclose(nov.numpy(), d, rtol=RTOL, atol=ATOL)


def test_single_empty_archive_raises():
    feats, archive, _ = make_inputs(8, 4, 1, 16)
    with pytest.raises(ValueError, match="empty archive"):
        pd.min_sq_distance(torch.from_numpy(feats),
                           torch.from_numpy(archive[:0]))


# -- the card kernels' split-TF32 arithmetic, emulated in numpy -------------
#
# On the card, B1 and B2 take the cross term f.a on the tensor cores in
# TF32 (10 mantissa bits), split as x = hi + lo with hi = rna(x) and
# lo = rna(x - hi), f.a ~ hi.hi' + hi.lo' + lo.hi', every coordinate first
# shifted by -1/2 (csrc/min_sq_pair.cu). The kernel cannot run here; these
# cases pin the precision decision: three products hold the min d2 within
# 3e-5 of exact arithmetic where it cancels to 0, one TF32 pass does not
# hold atol 1e-4.


def tf32_rna(x):
    """f32 ``x`` rounded to the nearest TF32 value, ties away from zero
    (cvt.rna.tf32.f32): add half of the 13 dropped bits to the magnitude,
    then clear them."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def split_tf32_min_d2(feats, rows, products):
    """Min d2 of each feature row to ``rows`` as the kernels compute it:
    f32 norms of the centred rows, the cross term from ``products`` TF32
    products (3: hi.hi' + hi.lo' + lo.hi'; 1: hi.hi'), each product exact
    and summed exactly, as the tensor cores do within a box."""
    fc, rc = feats - np.float32(0.5), rows - np.float32(0.5)
    fh, rh = tf32_rna(fc), tf32_rna(rc)
    fl, rl = tf32_rna(fc - fh), tf32_rna(rc - rh)
    wide = [x.astype(np.float64) for x in (fh, fl, rh, rl)]
    cross = wide[0] @ wide[2].T
    if products == 3:
        cross += wide[0] @ wide[3].T + wide[1] @ wide[2].T
    f2 = (fc * fc).sum(1, dtype=np.float32)
    r2 = (rc * rc).sum(1, dtype=np.float32)
    d2 = (f2[:, None] + r2[None]) - np.float32(2) * cross.astype(np.float32)
    return np.maximum(d2.min(1), 0.0)


def duplicate_inputs(dist, dup, seed, N=512, A=64, K=256):
    """Feature rows uniform in [0, 1) or near-binary (sigmoid of 8 x a
    normal, as the precedence features are), and rows copied from them:
    exactly (d2 = 0) or moved by +-1e-3 per coordinate."""
    rng = np.random.RandomState(seed)
    if dist == "uniform":
        feats = rng.rand(N, K).astype(np.float32)
    else:
        feats = (1.0 / (1.0 + np.exp(-8.0 * rng.randn(N, K)))).astype(
            np.float32)
    rows = feats[rng.choice(N, A, replace=False)].copy()
    if dup == "near":
        rows = (rows + 1e-3 * rng.choice([-1.0, 1.0], rows.shape)).astype(
            np.float32)
    return feats, rows


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("dup", ["exact", "near"])
@pytest.mark.parametrize("dist", ["uniform", "near-binary"])
def test_split_tf32_holds_f32_accuracy(dist, dup, seed):
    feats, rows = duplicate_inputs(dist, dup, seed)
    exact = ((feats.astype(np.float64)[:, None] - rows[None]) ** 2).sum(
        -1).min(1)
    three = split_tf32_min_d2(feats, rows, products=3)
    one = split_tf32_min_d2(feats, rows, products=1)
    assert np.abs(three - exact).max() <= 3e-5
    assert np.abs(one - exact).max() > 1e-4


def test_tf32_rna_rounds_to_nearest_ties_away():
    ulp = 2.0 ** -10  # TF32 spacing in [1, 2)
    x = np.array([1.0, 1.0 + ulp / 4, 1.0 + ulp / 2, 1.0 + 3 * ulp / 4,
                  -(1.0 + ulp / 2), 0.0], np.float32)
    want = np.array([1.0, 1.0, 1.0 + ulp, 1.0 + ulp, -(1.0 + ulp), 0.0],
                    np.float32)
    np.testing.assert_array_equal(tf32_rna(x), want)
    lo = tf32_rna(x - tf32_rna(x))
    assert np.all(np.abs(x - tf32_rna(x)) <= ulp / 2)
    assert np.all(np.abs(lo) <= ulp / 2)
