"""The benchmark's readers of the ingest's and the evolve's split
(``searchbench/metrics/``: ``ingest_read_s``, ``ingest_encode_s``,
``ingest_archive_s``, ``ingest_launches``, ``evolve_wait_s``,
``evolve_stall_s``) on a hand-built run: the window's requests with
their service timings, and a traced stretch of two serving threads."""

import pytest

from searchbench import trace
from searchbench.run import RunData, reader

A, B = (101, 0xA), (102, 0xB)


def _request(ok=True, **timings):
    return {"ok": ok, "timings": timings}


WINDOW = [
    _request(ingest_read=0.2, ingest_encode=0.1, ingest_archive=0.05,
             run=1.0, evolve_cpu=0.3, evolve_wait=0.5),
    _request(ingest_read=0.4, ingest_encode=0.3, ingest_archive=0.15,
             run=2.0, evolve_cpu=0.5, evolve_wait=1.0),
    # a CPU clock's ticks may read a stall below zero: it counts as such
    _request(ingest_read=0.3, ingest_encode=0.2, ingest_archive=0.1,
             run=1.0, evolve_cpu=0.6, evolve_wait=0.5),
    # not answered: left out
    _request(ok=False, ingest_read=9.0, ingest_encode=9.0,
             ingest_archive=9.0, run=9.0, evolve_cpu=0.0, evolve_wait=0.0),
]


def _run(window=WINDOW, stretch=None):
    return RunData(window, 0.0, 10.0, 1.0, stretch)


@pytest.mark.parametrize("metric, want", [
    ("ingest_read_s", 0.3), ("ingest_encode_s", 0.2),
    ("ingest_archive_s", 0.1), ("evolve_wait_s", 2.0 / 3),
    ("evolve_stall_s", (0.2 + 0.5 - 0.1) / 3)])
def test_timings_are_read_as_means_over_answered_requests(metric, want):
    assert reader(metric)(_run()) == pytest.approx(want)


def test_a_mean_stall_below_zero_reads_zero():
    ticked = [_request(run=1.0, evolve_cpu=0.6, evolve_wait=0.5)]
    assert reader("evolve_stall_s")(_run(ticked)) == 0.0


@pytest.mark.parametrize("metric", [
    "ingest_read_s", "ingest_encode_s", "ingest_archive_s",
    "evolve_wait_s", "evolve_stall_s"])
def test_a_program_without_the_timings_reads_nothing(metric):
    # the timings a program before the split reports
    old = [_request(ingest=0.5, ingest_read_encode=0.4, run=1.0,
                    rerank=0.1, save=0.01)]
    assert reader(metric)(_run(old)) is None


def _op(tid, launch, cat="kernel"):
    return trace.DeviceOp("k", cat, launch + 1e-4, launch + 2e-4, tid,
                          launch)


def _stretch(threads, spans=None):
    """A's ingest phases at 1-2 s (whole) and 7.5-8.5 s (cut by the
    stretch's end at 8 s); B's at 3-4 s and 5-5.5 s; an evolve of A's at
    2-3 s. Kernels: A 3 in its first ingest, 2 in the cut one, 1 in its
    evolve, a copy in its first ingest; B 2 and 1; an unmapped launcher
    (autograd's) inside A's ingest."""
    if spans is None:
        spans = [(A, "ingest", 1.0, 2.0), (A, "ingest_archive", 1.5, 2.0),
                 (A, "evolve", 2.0, 3.0), (A, "ingest", 7.5, 8.5),
                 (B, "ingest", 3.0, 4.0), (B, "ingest", 5.0, 5.5)]
    ops = ([_op(7, t) for t in (1.1, 1.6, 1.9, 7.6, 7.9, 2.5)]
           + [_op(7, 1.2, cat="gpu_memcpy")]
           + [_op(8, t) for t in (3.2, 3.8, 5.1)] + [_op(9, 1.3)])
    return trace.Stretch(0.0, 8.0, ops, spans, threads)


def test_ingest_launches_counts_whole_ingests_by_their_own_threads():
    got = reader("ingest_launches")(_run(stretch=_stretch({7: A, 8: B})))
    # 3 + 2 + 1 kernels over A's first and B's two ingests
    assert got == pytest.approx(6 / 3)


def test_ingest_launches_reads_nothing_for_an_unmapped_thread():
    read = reader("ingest_launches")
    assert read(_run(stretch=_stretch({7: A}))) is None


def test_ingest_launches_reads_nothing_without_ingest_phases():
    # a program that opens no ingest phase on the sidecar's path
    read = reader("ingest_launches")
    spans = [(A, "evolve", 2.0, 3.0)]
    assert read(_run(stretch=_stretch({7: A, 8: B}, spans))) is None
    assert read(_run()) is None
    # only an ingest cut by the stretch's end
    spans = [(A, "ingest", 7.5, 8.5)]
    assert read(_run(stretch=_stretch({7: A}, spans))) is None
