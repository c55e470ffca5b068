"""namazu_tpu_torch on the card: the pair-distance kernel (B1) and the
single-archive kernel (B2) against their plain versions, the wrapper's
input checks, and a small search that must launch B1 once per generation
and once more per surrogate re-rank. Every test needs a CUDA card and skips
without one; on a machine with a card run

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest

(``--noconftest`` skips tests/conftest.py, which sets JAX up; these tests
import no JAX.) Tolerance: rtol 1e-3 / atol 1e-4 (f32 sums in another
order), TF32 off."""

import numpy as np
import pytest
import torch

from namazu_tpu_torch.models.search import ScheduleSearch, SearchConfig
from namazu_tpu_torch.ops import pair_distance as pd
from namazu_tpu_torch.ops import trace_encoding as te

pytestmark = pytest.mark.cuda

RTOL, ATOL = 1e-3, 1e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("N,A,F,K,an,fn", [
    (33, 7, 5, 64, None, None),
    (300, 100, 7, 128, 50, 0),
    (1000, 513, 65, 256, 513, 1),
])
def test_kernel_matches_plain_version(card, N, A, F, K, an, fn):
    g = torch.Generator(device=card).manual_seed(N)
    feats, archive, failures = (torch.rand((n, K), generator=g,
                                           device=card) for n in (N, A, F))
    got = pd.min_sq_distance_pair(feats, archive, failures, an, fn)
    want = pd.min_sq_distance_pair_reference(feats, archive, failures, an,
                                             fn)
    torch.cuda.synchronize()
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("N,A,K,valid_n", [
    (33, 7, 64, None),
    (33, 7, 64, 0),
    (300, 100, 128, 50),
    (16384, 512, 256, 300),
])
def test_single_kernel_matches_plain_version(card, N, A, K, valid_n):
    g = torch.Generator(device=card).manual_seed(N + 1)
    feats, archive = (torch.rand((n, K), generator=g, device=card)
                      for n in (N, A))
    before = pd.SINGLE_LAUNCHES
    got = pd.min_sq_distance(feats, archive, valid_n)
    want = pd.min_sq_distance_reference(feats, archive, valid_n)
    torch.cuda.synchronize()
    assert pd.SINGLE_LAUNCHES == before + 1
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


def test_wrapper_refuses_what_the_kernel_does_not_take(card):
    feats = torch.rand((16, 32), device=card)
    rows = torch.rand((8, 32), device=card)
    with pytest.raises(ValueError, match="float32"):
        pd.min_sq_distance_pair(feats.double(), rows.double(), rows.double())
    with pytest.raises(ValueError, match="contiguous"):
        pd.min_sq_distance_pair(feats, rows.t().contiguous().t(), rows)
    with pytest.raises(ValueError, match="multiple of 4"):
        pd.min_sq_distance_pair(feats[:, :30].contiguous(),
                                rows[:, :30].contiguous(),
                                rows[:, :30].contiguous())


def test_small_search_launches_once_per_generation(card):
    rng = np.random.RandomState(0)

    def enc(n):
        return te.encode_event_stream(
            [f"h{rng.randint(40)}" for _ in range(n)],
            arrivals=np.sort(rng.rand(n)).tolist(), H=64)

    s = ScheduleSearch(SearchConfig(H=64, K=64, population=256,
                                    archive_size=32, failure_size=8,
                                    fused_chunk=4), device=card)
    for _ in range(5):
        s.add_executed_trace(enc(200))
    s.add_failure_trace(enc(200))
    before = pd.LAUNCHES
    best = s.run([enc(300), enc(1200)], generations=10)
    assert pd.LAUNCHES - before == 10
    assert np.isfinite(best.fitness)


def test_small_search_with_surrogate_launches_once_more(card):
    rng = np.random.RandomState(1)

    def enc(n):
        return te.encode_event_stream(
            [f"h{rng.randint(40)}" for _ in range(n)],
            arrivals=np.sort(rng.rand(n)).tolist(), H=64)

    s = ScheduleSearch(SearchConfig(H=64, K=64, population=256,
                                    archive_size=32, failure_size=8,
                                    fused_chunk=4, surrogate_topk=16),
                       device=card)
    for i in range(8):
        s.add_executed_trace(enc(200), reproduced=i % 2 == 0)
    s.add_failure_trace(enc(200))
    before = pd.LAUNCHES
    best = s.run([enc(300), enc(1200)], generations=10)
    assert pd.LAUNCHES - before == 11
    assert s._surrogate is not None and np.isfinite(best.fitness)
