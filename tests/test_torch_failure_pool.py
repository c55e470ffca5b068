"""The port's failure pool (namazu_tpu_torch/models/failure_pool.py,
utils/atomic.py) held to namazu_tpu/models/failure_pool.py: a pool one
package writes is read by the other, the JSON wire forms round-trip
across packages, digests equal the reference's, and concurrent writers
of one signature leave exactly one entry.

Inputs are made with numpy from a seed. Digests, seeds, pool entries and
their arrays must be equal exactly (the same f32 values travel)."""

import threading

import numpy as np
import pytest

from namazu_tpu.models import failure_pool as jfp
from namazu_tpu.ops import trace_encoding as jte
from namazu_tpu_torch.models import failure_pool as tfp
from namazu_tpu_torch.models import search as tsearch
from namazu_tpu_torch.ops import trace_encoding as tte

H = 32


def views(te, seed, n=40, L=64):
    """``(realized, arrival, seed table)`` of one synthetic failure."""
    rng = np.random.RandomState(seed)
    hints = [f"10.0.0.{rng.randint(5)}->10.0.0.{rng.randint(5)}:m"
             f"{rng.randint(3)}" for _ in range(n)]
    arr = np.cumsum(rng.rand(n) * 1e-3)
    rel = arr + rng.rand(n) * 0.02
    ents = [h.split("->")[0] for h in hints]
    realized = te.encode_event_stream(hints, rel.tolist(), ents, L=L, H=H)
    arrival = te.encode_event_stream(hints, arr.tolist(), ents, L=L, H=H)
    flt = rng.rand(L) < 0.8
    realized.faultable = flt & realized.mask
    arrival.faultable = realized.faultable
    table = (rng.rand(H) * 0.05).astype(np.float32) if seed % 3 else None
    return realized, arrival, table


def assert_same_entry(a, b):
    assert a.digest == b.digest
    for va, vb in ((a.realized, b.realized), (a.arrival, b.arrival)):
        for f in ("hint_ids", "entity_ids", "arrival", "mask", "faultable"):
            assert np.array_equal(getattr(va, f), getattr(vb, f)), f
    if a.seed is None:
        assert b.seed is None
    else:
        assert np.array_equal(a.seed, b.seed)


def test_digest_equals_reference_and_is_the_search_s():
    for s in range(5):
        t = views(tte, s)[0]
        j = views(jte, s)[0]
        assert tfp.trace_digest(t) == jfp.trace_digest(j)
    assert tsearch.trace_digest is tfp.trace_digest  # one definition


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_pool_written_by_one_package_loads_in_the_other(tmp_path, writer):
    pool = str(tmp_path / "pool")
    pkgs = {"reference": (jfp, jte), "port": (tfp, tte)}
    wfp, wte = pkgs[writer]
    rfp = pkgs["port" if writer == "reference" else "reference"][0]
    digests = []
    for s in range(6):
        realized, arrival, table = views(wte, s)
        d, added = wfp.pool_put(pool, realized, arrival, table, H)
        assert added
        digests.append(d)
    assert wfp.pool_put(pool, *views(wte, 0), H) == (digests[0], False)
    assert tfp.pool_size(pool) == jfp.pool_size(pool) == 6
    exclude = {digests[1], digests[4]}
    got = rfp.pool_load(pool, H, exclude=exclude)
    want = wfp.pool_load(pool, H, exclude=exclude)
    assert len(got) == len(want) == 4
    for a, b in zip(sorted(got, key=lambda e: e.digest),
                    sorted(want, key=lambda e: e.digest)):
        assert_same_entry(a, b)
    assert rfp.pool_load(pool, 2 * H) == []  # another bucket count
    assert tfp.pool_fsck(pool) == jfp.pool_fsck(pool)


def test_json_wire_forms_round_trip_across_packages():
    for s in range(4):
        t = views(tte, s)
        j = views(jte, s)
        dt = tfp.entry_to_jsonable(*t, H)
        assert dt == jfp.entry_to_jsonable(*j, H)
        got = tfp.entries_to_pool_entries([jfp.entry_to_jsonable(*j, H)], H)
        want = jfp.entries_to_pool_entries([dt], H)
        assert len(got) == len(want) == 1
        assert_same_entry(got[0], want[0])
    bad = dict(dt, faultable=dt["faultable"][:-1])
    other = dict(dt, hint_space="another-space")
    assert tfp.entries_to_pool_entries([bad, other, dt], 2 * H) == []
    with pytest.raises(ValueError):
        tfp.entry_from_jsonable(bad)


def test_concurrent_writers_leave_one_entry(tmp_path):
    """Eight threads race to pool the same signature and two others: the
    pool ends with exactly three entries and no temp file."""
    pool = str(tmp_path / "pool")
    entries = [views(tte, s) for s in (7, 8, 10)]
    results = []
    start = threading.Barrier(8)

    def writer(i):
        start.wait()
        for e in (entries[0], entries[1 + i % 2]):
            results.append(tfp.pool_put(pool, *e, H))

    threads = [threading.Thread(target=writer, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert jfp.pool_size(pool) == 3
    assert len({d for d, _ in results}) == 3
    report = tfp.pool_fsck(pool)
    assert report["entries"] == 3 and report["tmp_artifacts"] == []
    assert {e.digest for e in jfp.pool_load(pool, H)} == \
        {d for d, _ in results}


def test_fsck_sweeps_temps_and_quarantines_torn_entries(tmp_path):
    pool = tmp_path / "pool"
    tfp.pool_add(str(pool), *views(tte, 1), H)
    (pool / "abc.npz.123.tmp").write_bytes(b"half")
    (pool / "torn.npz").write_bytes(b"PK\x03\x04 not a zip")
    got = tfp.pool_fsck(str(pool))
    assert got == jfp.pool_fsck(str(pool))
    assert got["tmp_artifacts"] == ["abc.npz.123.tmp"]
    assert got["unreadable_entries"] == ["torn.npz"]
    fixed = tfp.pool_fsck(str(pool), repair=True)
    assert sorted(fixed["repaired"]) == ["abc.npz.123.tmp", "torn.npz"]
    assert (pool / "torn.npz.bad").exists()
    assert tfp.pool_fsck(str(pool))["entries"] == 1
