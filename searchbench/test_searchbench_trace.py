"""The trace's threads are mapped to the sink's by their marks, and a
kernel goes to a phase only through its own thread's mapping."""

from searchbench import trace

A, B = (101, 0xA), (102, 0xB)


def _op(tid, launch, name="k"):
    return trace.DeviceOp(name, "kernel", launch + 1e-4, launch + 2e-4,
                          tid, launch)


def _stretch(ops, threads):
    spans = [(A, "evolve", 1.0, 2.0), (B, "evolve", 1.5, 3.0)]
    return trace.Stretch(0.0, 4.0, ops, spans, threads)


def test_marks_name_threads():
    marks = [(A, 1.0, 1.0001), (B, 2.0, 2.0001), (A, 3.0, 3.0001)]
    calls = [(7, 1.00005), (8, 2.00002), (7, 3.0)]
    assert trace.map_threads(calls, marks) == {7: A, 8: B}


def test_a_stray_call_is_outvoted():
    # thread 8's call falls inside A's first mark; A's other marks hit
    # only 7
    marks = [(A, 1.0, 1.0001), (A, 2.0, 2.0001), (B, 3.0, 3.0001)]
    calls = [(7, 1.00005), (8, 1.00006), (7, 2.00005), (8, 3.00005)]
    assert trace.map_threads(calls, marks) == {7: A, 8: B}


def test_ambiguous_marks_name_nothing():
    # a tie within one thread's marks; one trace id named by two threads
    marks = [(A, 1.0, 1.0001), (B, 2.0, 2.0001)]
    assert trace.map_threads([(7, 1.00005), (8, 1.00006)], marks[:1]) == {}
    assert trace.map_threads([(7, 1.00005), (7, 2.00005)], marks) == {}


def test_kernels_go_to_their_own_threads_phase():
    ops = [_op(7, 1.2), _op(7, 2.5), _op(8, 1.7), _op(8, 3.5)]
    got = trace.kernels_in(_stretch(ops, {7: A, 8: B}), "evolve")
    # thread 7's launch at 2.5 lies in B's phase, not its own
    assert sorted(o.launch for o in got) == [1.2, 1.7]


def test_an_unmapped_thread_in_the_phase_reads_nothing():
    ops = [_op(7, 1.2), _op(8, 1.6)]
    assert trace.kernels_in(_stretch(ops, {7: A}), "evolve") is None


def test_other_launchers_do_no_harm():
    # a thread with no span of the phase (autograd's) launching inside
    # another thread's phase is not that thread's
    ops = [_op(7, 1.2), _op(8, 1.7), _op(9, 1.6)]
    got = trace.kernels_in(_stretch(ops, {7: A, 8: B}), "evolve")
    assert sorted(o.launch for o in got) == [1.2, 1.7]
