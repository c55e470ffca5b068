"""namazu_tpu_torch on the card: the pair-distance kernel against its plain
version, the wrapper's input checks, and a small search that must launch
the kernel once per generation. Every test needs a CUDA card and skips
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
