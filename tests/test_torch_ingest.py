"""The port's history reader, trace encoding of recorded runs and history
ingest (namazu_tpu_torch/history.py, ops/trace_encoding.py,
models/ingest.py) held to the reference's NaiveStorage, encode_trace_views
and ingest_history on storages the reference itself wrote from real
``Action.for_event`` actions.

Sizes are small (P=64, H=K=32, runs of a few hundred events). Tolerances:
exact for ints, bools, pairs, seeds, digests, labels, arrival offsets
(the same float64 arithmetic cast once to f32) and reference traces;
rtol 1e-3 / atol 1e-4 for archive features (f32 sums in another order)."""

import contextlib
import json
import threading
import time

import numpy as np
import pytest

from namazu_tpu.models import ingest as jingest
from namazu_tpu.models import search as jsearch
from namazu_tpu.ops import trace_encoding as jte
from namazu_tpu.signal import base as jbase
from namazu_tpu.signal.event import (
    FilesystemEvent,
    FilesystemOp,
    FunctionEvent,
    LogEvent,
    NopEvent,
    PacketEvent,
)
from namazu_tpu.storage import load_storage as jload
from namazu_tpu.storage import new_storage
from namazu_tpu.utils.trace import SingleTrace
from namazu_tpu_torch import history
from namazu_tpu_torch.models import ingest as tingest
from namazu_tpu_torch.models import search as tsearch
from namazu_tpu_torch.obs import Telemetry
from namazu_tpu_torch.ops import trace_encoding as tte
from test_torch_search import ATOL, RTOL, H, K, jax_cfg, port_cfg

T0 = 1.7e9  # wall-clock base of the recorded times


class SpanSink(Telemetry):
    """A telemetry sink that keeps each search phase's span, ``(phase,
    thread ident, start, end)`` in ``time.perf_counter`` seconds, in the
    order the phases closed."""

    def __init__(self):
        self.spans = []
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def search_phase(self, phase):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            span = (phase, threading.get_ident(), t0, time.perf_counter())
            with self._lock:
                self.spans.append(span)


def make_event(rng, i):
    kind = rng.randint(10)
    node = f"n{rng.randint(4)}"
    if kind < 6:
        return PacketEvent.create(node, node, f"n{rng.randint(4)}",
                                  hint=f"m{rng.randint(5)}")
    if kind == 6:
        return FilesystemEvent.create(node, FilesystemOp.PRE_WRITE,
                                      f"/d/{rng.randint(3)}")
    if kind == 7:
        return LogEvent.create(node, f"line {rng.randint(3)}")
    if kind == 8:
        return FunctionEvent.create(node, f"f{rng.randint(2)}")
    return NopEvent(entity_id=node)  # no hint: class + entity identity


def make_trace(rng, n_events, delay):
    """A recorded run: arrivals ~1 ms apart, releases ``delay`` s later
    on average; every 17th event lacks an arrival stamp and every 23rd a
    release stamp, so each view's fallback runs."""
    t = T0 + rng.rand() * 10
    actions = []
    for i in range(n_events):
        t += rng.exponential(1e-3)
        ev = make_event(rng, i)
        if i % 17 != 5:
            ev.mark_arrived(t)
        a = ev.default_action()
        if i % 23 != 7:
            a.mark_triggered(t + rng.rand() * delay)
        actions.append(a)
    return SingleTrace(actions)


def write_storage(path, runs=6, n_events=240, seed=0, quarantine=True,
                  unstamped=True):
    """Runs 0..runs-1 (every third a failure), one unstamped run and one
    quarantined run in between."""
    rng = np.random.RandomState(seed)
    st = new_storage("naive", str(path))
    st.create()
    for r in range(runs):
        ok = r % 3 != 1
        st.create_new_working_dir()
        st.record_new_trace(make_trace(rng, n_events,
                                       0.001 if ok else 0.03))
        st.record_result(ok, 0.5, metadata={"hint_space": jbase.HINT_SPACE})
        if r == 2 and quarantine:
            st.create_new_working_dir()
            st.record_new_trace(make_trace(rng, n_events, 0.03))
            st.quarantine_current_run("crashed")
        if r == 3 and unstamped:
            st.create_new_working_dir()
            st.record_new_trace(make_trace(rng, n_events, 0.03))
            st.record_result(False, 0.5, metadata={})
    return st


@pytest.fixture
def storage(tmp_path):
    return write_storage(tmp_path / "st")


def both_readers(st):
    return jload(st.dir), history.load_storage(st.dir)


def assert_same_encoding(a, b):
    for f in ("hint_ids", "entity_ids", "arrival", "mask", "faultable"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert a.truncated == b.truncated


@pytest.mark.parametrize("L", [None, 128])
def test_reader_and_views_match_reference(storage, L):
    js, ts = both_readers(storage)
    n = js.nr_stored_histories()
    assert ts.nr_stored_histories() == n == 8
    seen = 0
    for i in range(n):
        if js.is_quarantined(i):
            with pytest.raises(history.StorageError, match="quarantined"):
                ts.get_stored_history(i)
            continue
        jt, tt = js.get_stored_history(i), ts.get_stored_history(i)
        assert js.is_successful(i) == ts.is_successful(i)
        assert js.get_metadata(i) == ts.get_metadata(i)
        assert len(jt) == len(tt)
        for got, want in zip(tte.encode_trace_views(tt, L=L, H=H),
                             jte.encode_trace_views(jt, L=L, H=H)):
            assert_same_encoding(got, want)
        assert_same_encoding(tte.encode_trace(tt, L=L, H=H, realized=True),
                             jte.encode_trace(jt, L=L, H=H, realized=True))
        seen += 1
    assert seen == 7  # every run but the quarantined one
    if L is not None:
        assert tte.encode_trace(tt, L=L, H=H).truncated == 240 - L


def test_class_supports_fault_copy_matches_reference():
    names = list(jbase.known_signal_classes())
    assert set(names) == tte.FAULTABLE_CLASSES | tte.UNFAULTABLE_CLASSES
    for name in names + ["", "SomePluginEvent"]:
        assert tte.class_supports_fault(name) == \
            jte.class_supports_fault(name), name


@pytest.mark.parametrize("occupied", [[], [3, 9, 4], list(range(0, 32, 2))])
def test_informative_pairs_exact(occupied):
    for seed in (0, 7):
        assert np.array_equal(tte.informative_pairs(occupied, K, H, seed),
                              jte.informative_pairs(occupied, K, H, seed))


def test_failure_seed_and_envelope_exact(storage):
    js, ts = both_readers(storage)
    encs_t, encs_j, seeds = [], [], 0
    for i in (0, 1, 4, 5, 6, 7):
        jt, tt = js.get_stored_history(i), ts.get_stored_history(i)
        got = tingest.failure_seed(tt, H, 0.02)
        want = jingest.failure_seed(jt, H, 0.02)
        assert np.array_equal(got, want)
        seeds += int(np.count_nonzero(got))
        encs_t.append(tte.encode_trace(tt, H=H))
        encs_j.append(jte.encode_trace(jt, H=H))
    assert seeds > 0
    assert_same_encoding(tte.envelope_trace(encs_t),
                         jte.envelope_trace(encs_j))


def searches():
    return (jsearch.ScheduleSearch(jax_cfg(), n_devices=1),
            tsearch.ScheduleSearch(port_cfg(), device="cpu"))


@pytest.mark.parametrize("mode", ["recent", "envelope"])
def test_ingest_history_matches_reference(storage, mode):
    js, ts = searches()
    kw = dict(H=H, max_interval=0.05, reference_mode=mode,
              max_seed_genomes=2)
    js_st, ts_st = both_readers(storage)
    want = jingest.ingest_history(js, js_st, jingest.IngestParams(**kw))
    got = tingest.ingest_history(ts, ts_st, tingest.IngestParams(**kw))
    assert tingest.IngestParams._fields == jingest.IngestParams._fields
    assert len(got) == len(want) == (1 if mode == "envelope" else 4)
    for g, w in zip(got, want):
        assert_same_encoding(g, w)
    assert np.array_equal(ts.pairs, js.pairs)
    assert not np.array_equal(ts.pairs, tte.sample_pairs(K, H, 3))
    assert (ts._archive_n, ts._failure_n) == (js._archive_n, js._failure_n)
    assert ts._archive_n == 6 and ts._failure_n == 2
    assert np.array_equal(ts.archive_labels, js.archive_labels)
    assert ts._failure_digests == js._failure_digests
    np.testing.assert_allclose(ts.archive, js.archive, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ts.failures, js.failures, rtol=RTOL,
                               atol=ATOL)
    # the pair refit reset the best; the two failures seeded rows 0, 32
    assert float(ts._state.best_fitness) == float(js._state.best_fitness) \
        == float("-inf")
    jd = np.asarray(js._state.pop.delays)
    td = ts._state.pop.delays.numpy()
    for row in (0, 32):
        assert np.array_equal(td[row], jd[row])
        assert np.count_nonzero(td[row]) > 0
    # a second ingest keeps the pairs, re-adds every run, dedupes failures
    tingest.ingest_history(ts, ts_st, tingest.IngestParams(**kw))
    assert ts._archive_n == 12 and ts._failure_n == 2


def test_seed_population_writes_in_place():
    ts = tsearch.ScheduleSearch(port_cfg(), device="cpu")
    buf = ts._state.pop.delays
    before = buf.clone()
    ts.seed_population([np.full(H, 0.2, np.float32),
                        np.full(H, 0.01, np.float32)])
    assert ts._state.pop.delays is buf
    assert np.all(buf[0].numpy() == 0.05)  # clipped to max_delay
    assert np.all(buf[32].numpy() == 0.01)
    rest = [i for i in range(64) if i not in (0, 32)]
    assert np.array_equal(buf[rest].numpy(), before[rest].numpy())


def test_no_history_and_unreadable_runs(tmp_path):
    ts = tsearch.ScheduleSearch(port_cfg(), device="cpu")
    p = tingest.IngestParams(H=H)
    assert tingest.ingest_history(ts, None, p) == []
    empty = new_storage("naive", str(tmp_path / "empty"))
    empty.create()
    assert tingest.ingest_history(
        ts, history.load_storage(empty.dir), p) == []
    # only a quarantined and an unstamped run: nothing to ingest
    st = new_storage("naive", str(tmp_path / "q"))
    st.create()
    rng = np.random.RandomState(1)
    st.create_new_working_dir()
    st.record_new_trace(make_trace(rng, 30, 0.01))
    st.quarantine_current_run("crashed")
    st.create_new_working_dir()
    st.record_new_trace(make_trace(rng, 30, 0.01))
    st.record_result(False, 0.5, metadata={})
    assert tingest.ingest_history(
        ts, history.load_storage(st.dir), p) == []
    assert ts._archive_n == 0


def test_crashed_run_without_result_is_invisible(tmp_path):
    st = write_storage(tmp_path / "st", runs=2, quarantine=False,
                       unstamped=False)
    st.create_new_working_dir()
    st.record_new_trace(make_trace(np.random.RandomState(5), 50, 0.01))
    st.create_new_working_dir()
    st.record_new_trace(make_trace(np.random.RandomState(6), 50, 0.01))
    st.record_result(True, 0.5, metadata={"hint_space": jbase.HINT_SPACE})
    ts = history.load_storage(st.dir)
    assert ts.nr_stored_histories() == 4
    with pytest.raises(history.StorageError, match="no result"):
        ts.get_stored_history(2)
    assert len(ts.get_stored_history(3)) == 50
    # read-only: no quarantine marker was written
    assert not ts.is_quarantined(2)


def test_other_storage_types_raise_naming_the_type(tmp_path):
    d = tmp_path / "mongo"
    d.mkdir()
    (d / "storage.json").write_text(json.dumps({"type": "mongodb"}))
    with pytest.raises(history.StorageError, match="mongodb"):
        history.load_storage(str(d))
    with pytest.raises(history.StorageError, match="no storage.json"):
        history.load_storage(str(tmp_path))


def start_services(tmp_path):
    """A reference and a port sidecar, each hosting its own package's
    knowledge service; returns their addresses and a stop function."""
    from namazu_tpu.knowledge import KnowledgeService as JKnowledge
    from namazu_tpu.sidecar import SidecarServer as JSidecar
    from namazu_tpu_torch.knowledge import KnowledgeService as TKnowledge
    from namazu_tpu_torch.sidecar import SidecarServer as TSidecar

    js = JSidecar(port=0, knowledge=JKnowledge(str(tmp_path / "kj")))
    ts = TSidecar(port=0, device="cpu",
                  knowledge=TKnowledge(str(tmp_path / "kt"), device="cpu"))
    for srv in (js, ts):
        srv.start()

    def stop():
        for srv in (js, ts):
            srv.shutdown()

    return {"ref": f"127.0.0.1:{js.port}",
            "port": f"127.0.0.1:{ts.port}"}, stop


#: per package: (ingest module, storage reader, a fresh search)
PACKAGES = {
    "ref": (jingest, jload,
            lambda: jsearch.ScheduleSearch(jax_cfg(), n_devices=1)),
    "port": (tingest, history.load_storage,
             lambda: tsearch.ScheduleSearch(port_cfg(), device="cpu")),
}


@pytest.mark.parametrize("knobs", ["failure_pool", "knowledge", "guidance",
                                   "all"])
def test_pooled_knowledge_and_guided_ingest_match_reference(tmp_path, knobs):
    """Campaign A ingests its storage with the knobs on, then campaign B
    (another storage of the scenario) does: each package's B, fed through
    its own pool directory and its own knowledge service, holds the same
    pairs, digests, labels, seeds, archive and failure rows, DAG-shape
    fragments, coverage bits and references as the other's."""
    on = ({"failure_pool", "knowledge", "guidance"} if knobs == "all"
          else {knobs})
    a = write_storage(tmp_path / "A", seed=0)
    b = write_storage(tmp_path / "B", seed=1)
    addrs, stop = (start_services(tmp_path) if "knowledge" in on
                   else ({"ref": "", "port": ""}, lambda: None))
    states = {}
    try:
        for pkg, (ing, reader, fresh) in PACKAGES.items():
            def params(tenant):
                return ing.IngestParams(
                    H=H, max_interval=0.05, max_seed_genomes=8,
                    failure_pool=(str(tmp_path / f"pool-{pkg}")
                                  if "failure_pool" in on else ""),
                    knowledge=addrs[pkg], knowledge_tenant=tenant,
                    knowledge_scenario="scen",
                    guidance="guidance" in on)
            ing.ingest_history(fresh(), reader(a.dir), params("A"))
            search, stats = fresh(), {}
            kw = {"stats": stats} if pkg == "port" else {}
            if pkg == "port":
                search.telemetry = sink = SpanSink()
            refs = ing.ingest_history(search, reader(b.dir), params("B"),
                                      **kw)
            states[pkg] = (search, refs, stats)
    finally:
        stop()
    (js, jrefs, _), (ts, trefs, stats) = states["ref"], states["port"]
    assert len(trefs) == len(jrefs) == 4
    for g, w in zip(trefs, jrefs):
        assert_same_encoding(g, w)
    assert np.array_equal(ts.pairs, js.pairs)
    pooled = bool(on & {"failure_pool", "knowledge"})
    assert (ts._archive_n, ts._failure_n) == (js._archive_n, js._failure_n)
    assert ts._failure_n == (4 if pooled else 2)  # A's 2 fold into B
    assert ts._failure_digests == js._failure_digests
    assert np.array_equal(ts.archive_labels, js.archive_labels)
    np.testing.assert_allclose(ts.archive, js.archive, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ts.failures, js.failures, rtol=RTOL,
                               atol=ATOL)
    jd, td = np.asarray(js._state.pop.delays), ts._state.pop.delays.numpy()
    n_seeds = 4 if pooled else 2  # own failures first, then pooled ones
    for row in (i * (64 // n_seeds) for i in range(n_seeds)):
        assert np.array_equal(td[row], jd[row]) and td[row].any()
    if "guidance" in on:
        np.testing.assert_allclose(ts.guidance_feats, js.guidance_feats,
                                   rtol=RTOL, atol=ATOL)
        assert ts.guidance.bits_list() == js.guidance.bits_list()
        assert ts.guidance.runs_observed == js.guidance.runs_observed == \
            (8 if pooled else 6)
        assert stats["coverage_bits"] == ts.guidance.covered()
        assert np.array_equal(ts.guidance.mutation_bias(),
                              js.guidance.mutation_bias())
    else:
        assert ts.guidance is None and js.guidance is None
    if knobs == "knowledge":
        assert stats["warmstart_archive"] == 2
    assert stats["read_encode"] >= 0.0 and stats["archive"] >= 0.0
    assert ("knowledge" in stats) == ("knowledge" in on)
    assert ("pool_io" in stats) == pooled
    assert ("guidance_observe" in stats) == ("guidance" in on)
    # each timed section is a phase of the same name, and the reverse;
    # the storage's reads and the runs' encoding lie inside read_encode
    sections = {k for k, v in stats.items() if isinstance(v, float)}
    assert {"read", "encode"} <= sections
    assert {p[len("ingest_"):] for p, _, _, _ in sink.spans} == \
        sections - {"read", "encode"}
    assert 0.0 <= stats["read"] + stats["encode"] <= stats["read_encode"]
    for section in sections - {"read", "encode"}:
        spanned = sum(e - s for p, _, s, e in sink.spans
                      if p == f"ingest_{section}")
        assert spanned >= stats[section]


def test_fresh_storage_evolves_against_pooled_arrivals(tmp_path):
    """A storage with no runs of its own falls back to the pooled
    signatures' arrival views as its references, as the reference's
    ingest does."""
    from namazu_tpu.models.failure_pool import trace_digest as jdigest

    a = write_storage(tmp_path / "A", seed=0)
    empty = new_storage("naive", str(tmp_path / "empty"))
    empty.create()
    got = {}
    for pkg, (ing, reader, fresh) in PACKAGES.items():
        p = ing.IngestParams(H=H, failure_pool=str(tmp_path / f"p-{pkg}"))
        ing.ingest_history(fresh(), reader(a.dir), p)
        search = fresh()
        got[pkg] = (ing.ingest_history(search, reader(empty.dir), p),
                    search)
    (jrefs, js), (trefs, ts) = got["ref"], got["port"]
    assert len(trefs) == len(jrefs) == 2
    assert sorted(tsearch.trace_digest(r) for r in trefs) == \
        sorted(jdigest(r) for r in jrefs)
    assert ts._failure_digests == js._failure_digests
    assert ts._failure_n == 2
