"""The ingest's run cache (namazu_tpu_torch/models/ingest.py::RunCache,
history.py::NaiveHistory.run_tokens): a search fed through a cache and a
search fed the same storage without one end every ingest in the same
state, bit for bit, while the storage changes under them in every way a
run can change; and the cache reads again exactly the runs it must.

Each case drives two identical searches through the same ingests, one
with a cache and one without, and compares what the ingest fed each
(every archive and failure add with its views, the seed tables, the
occupied buckets, in order), their archives, rings, digests, counts,
populations and coverage maps, and the returned references, exactly.
The racy rule's clock (``ingest.wall_ns``) is moved 10 s ahead, so a
run is cached as soon as it is read, and each change waits 50 ms first,
past a filesystem timestamp's tick: a change must move the run's stat
token to be seen. Sizes are small (P=64, H=K=32, runs of 240 events)."""

import json
import os
import shutil
import time

import numpy as np
import pytest

from namazu_tpu.signal import base as jbase
from namazu_tpu_torch import history
from namazu_tpu_torch.models import ingest as tingest
from namazu_tpu_torch.models import search as tsearch
from namazu_tpu_torch.sidecar import SearchService
from test_torch_ingest import assert_same_encoding, make_trace, \
    write_storage
from test_torch_search import H, port_cfg

KW = dict(H=H, max_interval=0.05, max_seed_genomes=2, guidance=True)
AHEAD_NS = 10 * 10**9


@pytest.fixture
def ahead(monkeypatch):
    """The racy rule's clock 10 s ahead: every run read is cached."""
    monkeypatch.setattr(tingest, "wall_ns",
                        lambda: time.time_ns() + AHEAD_NS)


class Fed:
    """What the ingest feeds a search, in order."""

    def __init__(self, search):
        self.calls = []
        for name in ("add_executed_trace", "add_failure_trace",
                     "seed_population", "set_occupied_buckets"):
            real = getattr(search, name)
            setattr(search, name, self._wrap(name, real))

    def _wrap(self, name, real):
        def call(*a, **k):
            self.calls.append((name, a, k))
            return real(*a, **k)
        return call


def assert_same_value(a, b):
    if isinstance(a, tingest.te.EncodedTrace):
        assert_same_encoding(a, b)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert np.array_equal(a, b)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_same_value(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            assert_same_value(a[k], b[k])
    else:
        assert a == b


class Pair:
    """Two identical searches: ``a`` fed through a cache, ``b`` not."""

    def __init__(self):
        self.cache = tingest.RunCache()
        self.build()

    def build(self, **cfg):
        """New searches, as the sidecar builds one when a request's
        search parameters change; the cache stays."""
        self.a = tsearch.ScheduleSearch(port_cfg(**cfg), device="cpu")
        self.b = tsearch.ScheduleSearch(port_cfg(**cfg), device="cpu")
        self.fed_a, self.fed_b = Fed(self.a), Fed(self.b)

    def ingest(self, path, **kw):
        """One ingest into each; asserts the bar and returns the cached
        side's counts (its references in ``refs``)."""
        p = tingest.IngestParams(**dict(KW, **kw))
        sa, sb = {}, {}
        self.fed_a.calls.clear()
        self.fed_b.calls.clear()
        ra = tingest.ingest_history(self.a, history.load_storage(path), p,
                                    stats=sa, cache=self.cache)
        rb = tingest.ingest_history(self.b, history.load_storage(path), p,
                                    stats=sb)
        assert_same_value(ra, rb)
        self.refs = ra
        assert_same_value(self.fed_a.calls, self.fed_b.calls)
        a, b = self.a, self.b
        assert np.array_equal(a.pairs, b.pairs)
        assert (a._archive_n, a._failure_n) == (b._archive_n, b._failure_n)
        for name in ("archive", "archive_labels", "failures",
                     "guidance_feats"):
            assert np.array_equal(getattr(a, name), getattr(b, name)), name
        assert a._failure_digests == b._failure_digests
        assert np.array_equal(a._state.pop.delays.numpy(),
                              b._state.pop.delays.numpy())
        assert a.guidance.bits_list() == b.guidance.bits_list()
        for k in ("coverage_bits", "one_sided"):
            assert sa[k] == sb[k]
        assert sb["runs_cached"] == 0
        assert sa["runs_read"] + sa["runs_cached"] == sb["runs_read"]
        return sa


def settle():
    """Past a filesystem timestamp's tick, so a change moves a time."""
    time.sleep(0.05)


def run_dir(st, i):
    return os.path.join(st.dir, f"{i:08x}")


def rewrite(path, text):
    """Write ``text`` over ``path`` atomically (a new file renamed in)."""
    settle()
    with open(path + ".tmp", "w") as f:
        f.write(text)
    os.replace(path + ".tmp", path)


def read_text(path):
    with open(path) as f:
        return f.read()


def append_runs(st, path, p):
    settle()
    rng = np.random.RandomState(11)
    for ok in (False, True):
        st.create_new_working_dir()
        st.record_new_trace(make_trace(rng, 240, 0.03))
        st.record_result(ok, 0.5, metadata={"hint_space": jbase.HINT_SPACE})


def quarantine(st, path, p):
    rewrite(os.path.join(run_dir(st, 0), history.INCOMPLETE_MARKER), "x\n")


def result_atomic(st, path, p):
    res = os.path.join(run_dir(st, 0), "result.json")
    d = json.loads(read_text(res))
    assert d["successful"] is True
    rewrite(res, json.dumps(dict(d, successful=False)))


def result_in_place(st, path, p):
    res = os.path.join(run_dir(st, 0), "result.json")
    old = read_text(res)
    new = old.replace('"successful": true, "required_time": 0.5',
                      '"successful": false, "required_time": 25')
    assert new != old and len(new) == len(old)
    ino = os.stat(res).st_ino
    settle()
    with open(res, "r+") as f:
        f.write(new)
    assert os.stat(res).st_ino == ino


def result_in_place_mtime_kept(st, path, p):
    """The same rewrite, its times then set back (as ``cp -p`` or
    ``rsync -t`` leave a file): only the change time moves."""
    res = os.path.join(run_dir(st, 0), "result.json")
    before = os.stat(res)
    result_in_place(st, path, p)
    os.utime(res, ns=(before.st_atime_ns, before.st_mtime_ns))
    after = os.stat(res)
    assert (after.st_size, after.st_mtime_ns) == (before.st_size,
                                                  before.st_mtime_ns)


def trace_replaced(st, path, p):
    rewrite(os.path.join(run_dir(st, 0), "trace.json"),
            read_text(os.path.join(run_dir(st, 7), "trace.json")))


def dir_swapped(st, path, p):
    settle()
    shutil.copytree(run_dir(st, 6), run_dir(st, 0) + ".new")
    os.rename(run_dir(st, 0), run_dir(st, 0) + ".old")
    os.rename(run_dir(st, 0) + ".new", run_dir(st, 0))


def next_run_lowered(st, path, p):
    rewrite(os.path.join(st.dir, "storage.json"),
            json.dumps({"type": "naive", "next_run": 3}))


def other_path(st, path, p):
    """The same cache handed another storage: a copy with its run 0
    turned into a failure and its last run dropped."""
    settle()
    other = st.dir + "-copy"
    shutil.copytree(st.dir, other)
    res = os.path.join(other, f"{0:08x}", "result.json")
    rewrite(res, json.dumps(dict(json.loads(read_text(res)),
                                 successful=False)))
    rewrite(os.path.join(other, "storage.json"),
            json.dumps({"type": "naive", "next_run": 7}))
    path[0] = other


def hint_space(st, path, p):
    res = os.path.join(run_dir(st, 2), "result.json")
    d = json.loads(read_text(res))
    rewrite(res, json.dumps(dict(d, metadata={"hint_space": "content-v1"})))


def params(**kw):
    def change(st, path, p):
        p.update(kw)
    return change


def rebuilt_at_h16(st, path, p):
    """H changes in the search and the ingest at once (a search table
    of another H cannot seed this one)."""
    p.update(H=16, _cfg={"H": 16})


def corrupt(st, path, p):
    tr = os.path.join(run_dir(st, 4), "trace.json")
    p["_saved"] = read_text(tr)
    rewrite(tr, "not json")


def restore(st, path, p):
    rewrite(os.path.join(run_dir(st, 4), "trace.json"), p.pop("_saved"))


CASES = {
    "runs_appended": [append_runs],
    "quarantined": [quarantine],
    "result_rewritten_atomically": [result_atomic],
    "result_rewritten_in_place": [result_in_place],
    "result_rewritten_in_place_mtime_kept": [result_in_place_mtime_kept],
    "trace_replaced": [trace_replaced],
    "run_dir_swapped": [dir_swapped],
    "next_run_lowered": [next_run_lowered, append_runs],
    "storage_path_changed": [other_path],
    "H_changed": [rebuilt_at_h16],
    "L_changed": [params(L=100)],
    "release_mode_changed": [params(release_mode="reorder",
                                    order_mode_max_l=200)],
    "max_interval_changed": [params(max_interval=0.01)],
    "other_hint_space": [hint_space],
    "run_raises": [corrupt, restore],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cached_ingest_equals_uncached_as_the_storage_changes(
        tmp_path, ahead, case):
    st = write_storage(tmp_path / "st")
    path, p = [st.dir], {}
    pair = Pair()
    first = pair.ingest(path[0])
    assert (first["runs_read"], first["runs_cached"]) == (7, 0)
    again = pair.ingest(path[0])
    assert (again["runs_read"], again["runs_cached"]) == (0, 7)
    for step in CASES[case]:
        step(st, path, p)
        if "_cfg" in p:
            pair.build(**p.pop("_cfg"))
        kw = {k: v for k, v in p.items() if not k.startswith("_")}
        pair.ingest(path[0], **kw)
        # nothing changed since: every readable run comes from the
        # cache (a run that raises is tried again, and counts in neither)
        counts = pair.ingest(path[0], **kw)
        assert counts["runs_read"] == 0


def max_times(st):
    """Each run's latest mtime or ctime in its stat token (None without
    a result)."""
    return [None if t is None else
            max(x for s in t if s is not None for x in s[2:])
            for t in history.load_storage(st.dir).run_tokens()]


def test_racy_runs_are_read_again_until_they_are_older(tmp_path,
                                                       monkeypatch):
    st = write_storage(tmp_path / "st")
    times = max_times(st)
    readable = [i for i, t in enumerate(times) if t is not None]
    assert 3 not in readable  # quarantined before its result
    latest = max(times[i] for i in readable)
    pair = Pair()
    # every run changed within RACY_NS of the clock: read each time
    monkeypatch.setattr(tingest, "wall_ns", lambda: latest + 10**8)
    for _ in range(2):
        c = pair.ingest(st.dir)
        assert (c["runs_read"], c["runs_cached"]) == (len(readable), 0)
    # the clock RACY_NS past run 4's times: the runs strictly older are
    # cached, run 4 and those after it are not
    edge = times[4] + tingest.RACY_NS
    monkeypatch.setattr(tingest, "wall_ns", lambda: edge)
    pair.ingest(st.dir)
    older = [i for i in readable if times[i] < times[4]]
    assert 0 < len(older) < len(readable)
    c = pair.ingest(st.dir)
    assert c["runs_cached"] == len(older)
    assert c["runs_read"] == len(readable) - len(older)
    # later, every run is cached
    monkeypatch.setattr(tingest, "wall_ns", lambda: latest + 2 * 10**9)
    pair.ingest(st.dir)
    c = pair.ingest(st.dir)
    assert (c["runs_read"], c["runs_cached"]) == (0, len(readable))


def test_cached_views_are_never_written_into(tmp_path, ahead):
    """Several ingests and searches later, each cached run still equals a
    fresh read and encode of its files."""
    st = write_storage(tmp_path / "st")
    pair = Pair()
    for _ in range(3):
        pair.ingest(st.dir)
        for search in (pair.a, pair.b):
            search.run(pair.refs, generations=2)
    cached = pair.cache._runs
    assert sorted(cached) == [0, 1, 2, 4, 5, 6, 7]
    reader = history.load_storage(st.dir)
    p = tingest.IngestParams(**KW)
    for i, (_, run) in cached.items():
        lap = {"read": 0.0, "encode": 0.0}
        fresh = tingest._encode(*tingest._read(reader.read_run, i, lap),
                                p, None, lap)
        assert fresh.stamp == run.stamp and fresh.ok == run.ok
        assert_same_value(list(fresh[2:]), list(run[2:]))


class Tokenless:
    """The port's reader behind the four calls alone, as the policy shim
    hands in the reference's storage: no stat tokens."""

    def __init__(self, path):
        self._h = history.load_storage(path)

    def nr_stored_histories(self):
        return self._h.nr_stored_histories()

    def get_stored_history(self, i):
        return self._h.get_stored_history(i)

    def is_successful(self, i):
        return self._h.is_successful(i)

    def get_metadata(self, i):
        return self._h.get_metadata(i)


def test_a_storage_without_tokens_is_read_in_full(tmp_path, ahead):
    st = write_storage(tmp_path / "st")
    cache = tingest.RunCache()
    searches = [tsearch.ScheduleSearch(port_cfg(), device="cpu")
                for _ in range(2)]
    p = tingest.IngestParams(**KW)
    for _ in range(2):
        stats = {}
        got = tingest.ingest_history(searches[0], Tokenless(st.dir), p,
                                     stats=stats, cache=cache)
        want = tingest.ingest_history(searches[1],
                                      history.load_storage(st.dir), p)
        assert (stats["runs_read"], stats["runs_cached"]) == (7, 0)
        assert_same_value(got, want)
        assert not cache._runs
    assert np.array_equal(searches[0].archive, searches[1].archive)


def test_run_tokens_and_read_run_agree_with_the_reader(tmp_path):
    st = write_storage(tmp_path / "st")
    st.create_new_working_dir()  # a run without a result, last
    reader = history.load_storage(st.dir)
    tokens = reader.run_tokens()
    assert len(tokens) == 9 and tokens[8] is None
    assert max(i + 1 for i, t in enumerate(tokens) if t is not None) \
        == reader.nr_stored_histories() == 8
    for i in range(8):
        if i == 3:
            with pytest.raises(history.StorageError, match="quarantined"):
                reader.read_run(i)
            continue
        trace, ok, meta = reader.read_run(i)
        assert trace == reader.get_stored_history(i)
        assert ok == reader.is_successful(i)
        assert meta == reader.get_metadata(i)


def test_the_sidecar_reads_only_new_runs(tmp_path, ahead):
    """Two requests on a growing storage: the second reads the new run
    alone, and answers as a service whose cache was cleared does."""
    from test_torch_sidecar import search_req

    st = write_storage(tmp_path / "st", quarantine=False)
    services = [SearchService(device="cpu") for _ in range(2)]
    for svc in services:
        assert svc.handle(search_req(st))["ok"]
        assert svc.ingest_counts[st.dir]["runs_read"] == 7
    append_runs(st, None, None)
    services[1]._run_caches.clear()
    got, want = (svc.handle(search_req(st)) for svc in services)
    counts = services[0].ingest_counts[st.dir]
    assert (counts["runs_read"], counts["runs_cached"]) == (2, 7)
    assert (services[1].ingest_counts[st.dir]["runs_read"]) == 9
    assert got["ok"] and got == want
