"""The port's bench (namazu_tpu_torch/bench.py) held to the reference's
(bench.py) on the CPU, at small sizes: the same inputs (exactly; the
population aside, which the reference draws with ``jax.random``), the
same numpy baseline, the scoring chain within rtol 1e-3 / atol 1e-4 of
the reference's ``fori_loop`` chain run by JAX on the CPU (f32 sums in
another order), the same regression gate, the JSON line's keys, and a
history of the port's own that never touches the reference's files."""

import json
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jbench
from namazu_tpu.models.ga import GAConfig as JGAConfig
from namazu_tpu.models.ga import init_population as jinit_population
from namazu_tpu.ops import schedule as jsched
from namazu_tpu.ops import trace_encoding as jte
from namazu_tpu_torch import bench as tbench

RTOL, ATOL = 1e-3, 1e-4
REPO = pathlib.Path(__file__).resolve().parents[1]
#: small sizes: P, H, L, K, A, F (K = 64 and P = 64 for the chain)
SMALL = (64, 64, 128, 64, 64, 16)
REFERENCE_FILES = ("BENCH_TPU_LAST_GOOD.json", "BENCH_HISTORY.jsonl")
SCORER_KEYS = {"metric", "value", "unit", "vs_baseline", "platform", "card",
               "check_max_abs_err"}
FUSED_KEYS = {"metric", "value", "unit", "fused", "generations_per_dispatch",
              "population", "unfused_schedules_per_sec", "vs_unfused",
              "platform", "card", "scorer_source", "smoke"}


def reference_inputs(P, H, L, K, A, F):
    """``bench.py``'s inputs as its ``main`` and ``fused_main`` build them
    (``min(240, L - 16)`` events; 240 at L = 256)."""
    n_ev = min(240, L - 16)
    enc = jte.encode_event_stream(
        [f"hint:{i % 96}" for i in range(n_ev)],
        arrivals=[i * 1e-3 for i in range(n_ev)], L=L, H=H)
    pairs = jte.sample_pairs(K, H, 0)
    archive = np.random.RandomState(0).rand(A, K).astype(np.float32)
    failures = np.random.RandomState(1).rand(F, K).astype(np.float32)
    delays = np.asarray(jinit_population(jax.random.PRNGKey(0), P, H,
                                         JGAConfig(max_delay=0.1)).delays)
    return enc, pairs, archive, failures, delays


@pytest.mark.parametrize("sizes", [SMALL, tbench.PRODUCTION[:6]],
                         ids=["small", "production"])
def test_inputs_equal_the_reference_bench(sizes):
    enc, pairs, archive, failures, _ = reference_inputs(*sizes)
    inp = tbench.bench_inputs(*sizes, "cpu")
    np.testing.assert_array_equal(inp.trace.hint_ids.numpy(), enc.hint_ids)
    np.testing.assert_array_equal(inp.trace.arrival.numpy(), enc.arrival)
    np.testing.assert_array_equal(inp.trace.mask.numpy(), enc.mask)
    np.testing.assert_array_equal(inp.pairs.numpy(), pairs)
    assert inp.archive.numpy().tobytes() == archive.tobytes()
    assert inp.failures.numpy().tobytes() == failures.tobytes()
    P, H = sizes[:2]
    d = inp.pop.delays
    assert d.shape == (P, H) and float(d.min()) >= 0.0 \
        and float(d.max()) <= 0.1


def test_numpy_score_equals_the_reference():
    enc, pairs, archive, failures, delays = reference_inputs(*SMALL)
    args = (delays, enc.hint_ids, enc.arrival, enc.mask, pairs, archive,
            failures)
    want = jbench.numpy_score(*args)
    got = tbench.numpy_score(*args)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_score_chain_matches_the_reference_fori_loop():
    """Three passes from the reference's population, then each side's
    fitness of the chained genomes (the perturbation alone is ~1e-8)."""
    passes = 3
    enc, pairs, archive, failures, delays = reference_inputs(*SMALL)
    jtrace = jsched.TraceArrays(jnp.asarray(enc.hint_ids),
                                jnp.asarray(enc.arrival),
                                jnp.asarray(enc.mask))
    jargs = (jtrace, jnp.asarray(pairs), jnp.asarray(archive),
             jnp.asarray(failures), jsched.ScoreWeights())

    @jax.jit
    def jchain(d):
        def step(_, d):
            fit, _f = jsched.score_population(d, *jargs)
            return d + 1e-9 * fit[:, None]
        d = jax.lax.fori_loop(0, passes, step, d)
        return d, jsched.score_population(d, *jargs)[0]

    want_d, want_fit = (np.asarray(x) for x in jchain(jnp.asarray(delays)))
    inp = tbench.bench_inputs(*SMALL, "cpu")
    got_d = tbench.score_chain(torch.from_numpy(delays.copy()), inp, passes)
    got_fit, _ = tbench.score_population(got_d, inp.trace, inp.pairs,
                                         inp.archive, inp.failures,
                                         tbench.WEIGHTS)
    np.testing.assert_allclose(got_d.numpy(), want_d, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_fit.numpy(), want_fit, rtol=RTOL,
                               atol=ATOL)


def history(platform="cuda", rates=(100.0, 120.0), coverage=None,
            metric=None, fused=None):
    out = []
    for r in rates:
        rec = {"platform": platform, "schedules_per_sec": r}
        if coverage is not None:
            rec["coverage"] = coverage
        if metric is not None:
            rec["metric"] = metric
        if fused is not None:
            rec["fused"] = fused
        out.append(rec)
    return out


@pytest.mark.parametrize("current,hist,threshold", [
    ({"platform": "cuda", "schedules_per_sec": 110.0}, history(), 30.0),
    ({"platform": "cuda", "schedules_per_sec": 60.0}, history(), 30.0),
    ({"platform": "cuda", "schedules_per_sec": 60.0}, history(), 60.0),
    ({"platform": "cpu", "schedules_per_sec": 1.0}, history(), 30.0),
    ({"platform": "cuda", "schedules_per_sec": 1.0}, [], 30.0),
    ({"platform": "cuda", "schedules_per_sec": 110.0, "coverage": 0.2},
     history(coverage=0.5), 30.0),
    ({"platform": "cuda", "schedules_per_sec": 110.0, "coverage": 0.45},
     history(coverage=0.5), 30.0),
    ({"platform": "cuda", "schedules_per_sec": 60.0, "fused": True},
     history(), 30.0),
    ({"platform": "cuda", "schedules_per_sec": 60.0, "fused": True},
     history(fused=True), 30.0),
    ({"platform": "cuda", "value": 10.0, "metric": "other"},
     history(metric="other"), 30.0),
    ({"platform": "cuda", "schedules_per_sec": 50.0},
     history(rates=[500.0] + [100.0] * 20), 30.0),
], ids=["same-under", "same-over", "same-wide-threshold", "other-platform",
        "no-history", "coverage-over", "coverage-under", "fused-vs-unfused",
        "fused-vs-fused", "other-metric", "window"])
def test_gate_record_equals_the_reference(current, hist, threshold):
    got = tbench.gate_record(current, hist, threshold_pct=threshold)
    want = jbench.gate_record(current, hist, threshold_pct=threshold)
    assert got == want


def reference_files(*more):
    """The bytes of the reference's bench files (and ``more`` files) at
    the repository root, None for one that is absent."""
    return {n: (REPO / n).read_bytes() if (REPO / n).exists() else None
            for n in REFERENCE_FILES + more}


def test_fused_smoke_prints_one_line_and_appends_nothing(tmp_path, capsys):
    before = reference_files()
    path = tmp_path / "history.jsonl"
    assert tbench.main(["--fused", "--smoke", "--device", "cpu",
                        "--history", str(path)]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert set(out) == FUSED_KEYS
    assert out["platform"] == "cpu" and out["card"] is None
    assert out["smoke"] is True and out["fused"] is True
    assert out["population"] == 256 and out["generations_per_dispatch"] == 8
    assert out["value"] > 0 and out["unfused_schedules_per_sec"] > 0
    assert not path.exists()
    assert reference_files() == before


def test_scorer_bench_on_the_cpu_at_small_sizes():
    out = tbench.run_scorer_bench("cpu", tbench.Sizes(*SMALL, 2, 2))
    assert set(out) == SCORER_KEYS
    assert out["metric"] == jbench.SCORER_METRIC
    assert out["platform"] == "cpu" and out["card"] is None
    assert out["value"] > 0 and out["vs_baseline"] > 0
    assert out["check_max_abs_err"] == 0.0  # the CPU against itself


def test_the_accuracy_check_raises_on_a_mismatch(monkeypatch):
    inp = tbench.bench_inputs(*SMALL, "cpu")
    real = tbench.score_population

    def off_on_the_full_population(delays, *a, **kw):
        fit, feats = real(delays, *a, **kw)
        return (fit + 1.0 if delays.shape[0] == SMALL[0] else fit), feats

    monkeypatch.setattr(tbench, "score_population",
                        off_on_the_full_population)
    with pytest.raises(RuntimeError, match="differs from the CPU"):
        tbench.check_against_cpu(inp, n=16)


def test_history_round_trips_and_gates(tmp_path, capsys):
    path = str(tmp_path / "h.jsonl")
    before = reference_files()
    out = {"metric": tbench.SCORER_METRIC, "value": 100.0,
           "unit": "schedules/s", "vs_baseline": 3.0, "platform": "cuda",
           "card": "X, 700.00 W", "check_max_abs_err": 0.0}
    tbench.append_history({"a": 1, "b": [2.5, "c"]}, path)
    assert tbench.load_history(path) == [{"a": 1, "b": [2.5, "c"]}]
    os.remove(path)
    assert tbench.publish(dict(out), path) == 0
    (rec,) = tbench.load_history(path)
    assert {k: rec[k] for k in ("metric", "schedules_per_sec", "unit",
                                "vs_baseline", "platform", "card")} == {
        "metric": tbench.SCORER_METRIC, "schedules_per_sec": 100.0,
        "unit": "schedules/s", "vs_baseline": 3.0, "platform": "cuda",
        "card": "X, 700.00 W"}
    with open(path, "a") as f:
        f.write("not json\n")
    assert tbench.publish(dict(out, value=50.0), path, gate=True) == 1
    assert "GATE FAILED" in capsys.readouterr().err
    assert [r["schedules_per_sec"] for r in tbench.load_history(path)] \
        == [100.0, 50.0]
    assert reference_files() == before


def test_the_default_history_is_the_ports_own(monkeypatch):
    monkeypatch.delenv("NMZ_TORCH_BENCH_HISTORY", raising=False)
    assert tbench.default_history_path() == str(
        REPO / "BENCH_HISTORY_TORCH.jsonl")
    monkeypatch.setenv("NMZ_TORCH_BENCH_HISTORY", "/elsewhere.jsonl")
    assert tbench.default_history_path() == "/elsewhere.jsonl"
    assert "BENCH_HISTORY_TORCH.jsonl" in (REPO / ".gitignore").read_text()


def test_without_a_card_main_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tbench.main([])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tbench.main(["--fused", "--smoke"])


def test_a_one_island_ring_plans_no_migration():
    from namazu_tpu_torch.parallel.islands import one_island, ring_plan

    assert ring_plan(one_island("cpu"), tbench.RINGS, 8192, tbench.GA) == []


def test_chip_smoke_rehearses_the_bench_path():
    """chip_smoke.py's phase 16 on the CPU at the smoke sizes: both
    benches in-process, their records in a temporary history (the smoke
    run's none)."""
    import chip_smoke

    before = reference_files("BENCH_HISTORY_TORCH.jsonl")
    launches, numbers = chip_smoke.drive_bench_path("cpu", tbench.SMOKE)
    assert set(launches) == {"bench_scorer", "bench_fused"}
    assert set(numbers["bench_scorer"]) == SCORER_KEYS
    assert set(numbers["bench_fused"]) == FUSED_KEYS
    assert reference_files("BENCH_HISTORY_TORCH.jsonl") == before
