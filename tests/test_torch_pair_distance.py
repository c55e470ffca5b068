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
