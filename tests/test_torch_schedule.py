"""The port's delay-mode scorer (namazu_tpu_torch/ops/schedule.py) held to
namazu_tpu/ops/schedule.py on the same inputs, made with numpy from a seed.

Release and first-occurrence times are one f32 add and a min, so they
must match exactly. Features, distances and fitness are held to rtol
1e-3 / atol 1e-4 (sigmoid and f32 sums may round differently), and the
top-8 genomes by fitness must be the same."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from namazu_tpu.ops import schedule as js
from namazu_tpu_torch.ops import schedule as ts
from namazu_tpu_torch.ops import trace_encoding as te

RTOL, ATOL = 1e-3, 1e-4
P, H, K, T = 64, 32, 32, 3
LENGTHS = {"dense": 128, "blockwise": 1536}


def make_case(L, seed=0):
    rng = np.random.RandomState(seed)
    hint = rng.randint(0, H, size=(T, L)).astype(np.int32)
    arrival = np.sort(rng.rand(T, L).astype(np.float32) * 0.5, axis=1)
    mask = np.zeros((T, L), bool)
    for t in range(T):  # ragged valid lengths
        mask[t, : L - 17 * t] = True
    delays = (rng.rand(P, H) * 0.05).astype(np.float32)
    pairs = te.sample_pairs(K, H, seed)
    archive = rng.rand(16, K).astype(np.float32)
    failures = rng.rand(4, K).astype(np.float32)
    return hint, arrival, mask, delays, pairs, archive, failures


def jtrace(hint, arrival, mask):
    return js.TraceArrays(jnp.asarray(hint), jnp.asarray(arrival),
                          jnp.asarray(mask))


def ttrace(hint, arrival, mask):
    return ts.TraceArrays(torch.from_numpy(hint).long(),
                          torch.from_numpy(arrival), torch.from_numpy(mask))


def close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def test_release_times_and_first_occurrence_exact():
    hint, arrival, mask, delays, *_ = make_case(128)
    jt, tt = jtrace(hint[0], arrival[0], mask[0]), ttrace(hint[0],
                                                          arrival[0],
                                                          mask[0])
    d = delays[5]
    want_t = js.release_times(jnp.asarray(d), jt)
    got_t = ts.release_times(torch.from_numpy(d), tt)
    assert np.array_equal(got_t.numpy(), np.asarray(want_t))
    want_first = js.first_occurrence(want_t, jt, H)
    got_first = ts.first_occurrence(got_t, tt, H)
    assert np.array_equal(got_first.numpy(), np.asarray(want_first))


@pytest.mark.parametrize("L", [700, 1536])
def test_blockwise_first_occurrence_matches_reference_exactly(L):
    hint, arrival, mask, delays, *_ = make_case(L, seed=1)
    d = delays[3]
    want, _ = js.first_occurrence_blockwise(
        jnp.asarray(d), jnp.asarray(hint[1]), jnp.asarray(arrival[1]),
        jnp.asarray(mask[1]))
    got, ndrop = ts.first_occurrence_blockwise(
        torch.from_numpy(d), ttrace(hint[1], arrival[1], mask[1]))
    assert ndrop is None  # no fault half, no drop count
    assert np.array_equal(got.numpy(), np.asarray(want))
    # and the port's blockwise and dense paths agree with each other
    tt = ttrace(hint[1], arrival[1], mask[1])
    dense = ts.first_occurrence(ts.release_times(torch.from_numpy(d), tt),
                                tt, H)
    assert torch.equal(got, dense)


def test_precedence_features_match():
    rng = np.random.RandomState(2)
    first = (rng.rand(P, H) * 0.1).astype(np.float32)
    first[:, :4] = js.BIG  # absent buckets saturate to 0 or 1 (or 0.5)
    pairs = te.sample_pairs(K, H, 2)
    want = jax.vmap(lambda f: js.precedence_features(
        f, jnp.asarray(pairs), 0.005))(jnp.asarray(first))
    got = ts.precedence_features(torch.from_numpy(first),
                                 torch.from_numpy(pairs), 0.005)
    close(got.numpy(), want)


@pytest.mark.parametrize("kind", sorted(LENGTHS))
def test_trace_features_match(kind):
    hint, arrival, mask, _, pairs, *_ = make_case(LENGTHS[kind], seed=3)
    want = js.trace_features(jtrace(hint[2], arrival[2], mask[2]),
                             jnp.asarray(pairs), 0.005, H)
    got = ts.trace_features(ttrace(hint[2], arrival[2], mask[2]),
                            torch.from_numpy(pairs), 0.005, H)
    close(got.numpy(), want)


def assert_same_ranking(got_fit, want_fit):
    close(got_fit, want_fit)
    top_got = np.argsort(-np.asarray(got_fit), kind="stable")[:8]
    top_want = np.argsort(-np.asarray(want_fit), kind="stable")[:8]
    assert np.array_equal(top_got, top_want)


@pytest.mark.parametrize("kind", sorted(LENGTHS))
def test_score_population_matches(kind):
    hint, arrival, mask, delays, pairs, archive, failures = make_case(
        LENGTHS[kind], seed=4)
    w = js.ScoreWeights()
    want_fit, want_feats = js.score_population(
        jnp.asarray(delays), jtrace(hint[0], arrival[0], mask[0]),
        jnp.asarray(pairs), jnp.asarray(archive), jnp.asarray(failures), w)
    got_fit, got_feats = ts.score_population(
        torch.from_numpy(delays), ttrace(hint[0], arrival[0], mask[0]),
        torch.from_numpy(pairs), torch.from_numpy(archive),
        torch.from_numpy(failures), ts.ScoreWeights(*w))
    assert got_fit.shape == (P,) and got_feats.shape == (P, K)
    close(got_feats.numpy(), want_feats)
    assert_same_ranking(got_fit.numpy(), want_fit)


@pytest.mark.parametrize("kind", sorted(LENGTHS))
def test_score_population_multi_matches(kind):
    hint, arrival, mask, delays, pairs, archive, failures = make_case(
        LENGTHS[kind], seed=5)
    w = js.ScoreWeights(novelty=0.7, bug=1.3, delay_cost=0.02)
    want_fit, want_feats = js.score_population_multi(
        jnp.asarray(delays), jtrace(hint, arrival, mask),
        jnp.asarray(pairs), jnp.asarray(archive), jnp.asarray(failures), w,
        novelty_scale=jnp.asarray(0.5, jnp.float32),
        archive_n=jnp.asarray(9, jnp.int32),
        failure_n=jnp.asarray(4, jnp.int32))
    got_fit, got_feats = ts.score_population_multi(
        torch.from_numpy(delays), ttrace(hint, arrival, mask),
        torch.from_numpy(pairs), torch.from_numpy(archive),
        torch.from_numpy(failures), ts.ScoreWeights(*w),
        novelty_scale=0.5, archive_n=9, failure_n=torch.tensor(4))
    assert got_fit.shape == (P,) and got_feats.shape == (P, T, K)
    close(got_feats.numpy(), want_feats)
    assert_same_ranking(got_fit.numpy(), want_fit)


def test_score_weights_fields_match_reference():
    assert ts.ScoreWeights._fields == js.ScoreWeights._fields
    assert tuple(ts.ScoreWeights()) == tuple(js.ScoreWeights())
    assert ts.TraceArrays._fields == js.TraceArrays._fields
    assert (ts.BIG, ts.MASK_BIG) == (js.BIG, js.MASK_BIG)
    assert (ts.LONG_TRACE_THRESHOLD, ts.LONG_TRACE_CHUNK) == \
        (js.LONG_TRACE_THRESHOLD, js.LONG_TRACE_CHUNK)
