"""Causality guidance in the port (namazu_tpu_torch/guidance/, the guided
parts of models/search.py and convert.py) held to namazu_tpu/guidance and
namazu_tpu/models/search.py on the same inputs, made with numpy from a
seed: storages the reference itself wrote (test_torch_ingest.py), read
and encoded by each package.

Tolerances: signatures, bitmaps, reverse bits, pair tables, coverage
deltas, mutation biases and guided populations given the reference's
draws are equal exactly; DAG-shape fragments, gains and ``guidance_feats``
within rtol 1e-3 / atol 1e-4; a guided pick must choose the reference's
winner. Sizes: H = K = 32, archive 16, P = 64."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from namazu_tpu import guidance as jg
from namazu_tpu.models import ingest as jingest
from namazu_tpu.models import search as jsearch
from namazu_tpu.ops import trace_encoding as jte
from namazu_tpu.parallel.islands import make_multiaxis_island_step
from namazu_tpu_torch import convert, guidance as tg
from namazu_tpu_torch import history
from namazu_tpu_torch.models import ga as tga
from namazu_tpu_torch.models import ingest as tingest
from namazu_tpu_torch.models import search as tsearch
from namazu_tpu_torch.ops import schedule as tsched
from namazu_tpu_torch.ops import trace_encoding as tte
from namazu_tpu_torch.parallel import islands as tisl
from test_torch_ga import jax_draws
from test_torch_ingest import write_storage
from test_torch_search import (
    ATOL,
    RTOL,
    H,
    K,
    jax_arrays,
    jax_cfg,
    port_cfg,
    port_traces,
)

G = jg.GUIDANCE_DIMS


def realized_views(st_dir, te, reader):
    """Both views of every stamped, readable run of a storage."""
    st = reader(st_dir)
    out = []
    for i in range(st.nr_stored_histories()):
        try:
            trace = st.get_stored_history(i)
            ok = st.is_successful(i)
            meta = st.get_metadata(i) or {}
        except Exception:
            continue
        if meta.get("hint_space") != te.HINT_SPACE:
            continue
        out.append((*te.encode_trace_views(trace, H=H), ok, trace))
    return out


@pytest.fixture(scope="module")
def storage(tmp_path_factory):
    return write_storage(tmp_path_factory.mktemp("g") / "st", runs=12)


@pytest.fixture(scope="module")
def both_views(storage):
    from namazu_tpu.storage import load_storage as jload

    return (realized_views(storage.dir, tte, history.load_storage),
            realized_views(storage.dir, jte, jload))


# -- signatures and the coverage map ----------------------------------------


def test_signatures_equal_the_reference(both_views):
    port, ref = both_views
    assert len(port) == len(ref) == 12
    for (a_t, r_t, _, trace_t), (a_j, r_j, _, trace_j) in zip(port, ref):
        seq_t = tg.bucket_sequence_from_encoded(r_t)
        seq_j = jg.bucket_sequence_from_encoded(r_j)
        assert np.array_equal(seq_t, seq_j)
        assert np.array_equal(tg.bucket_sequence_from_trace(trace_t, H),
                              jg.bucket_sequence_from_trace(trace_j, H))
        times = a_t.arrival + np.float32(0.003) * (a_t.hint_ids % 5)
        assert np.array_equal(
            tg.bucket_sequence_from_encoded(a_t, times),
            jg.bucket_sequence_from_encoded(a_j, times))
        for w, win in ((4096, 16), (512, 4)):
            assert np.array_equal(tg.signature_bits(seq_t, w, win),
                                  jg.signature_bits(seq_j, w, win))
            assert np.array_equal(tg.reverse_signature_bits(seq_t, w, win),
                                  jg.reverse_signature_bits(seq_j, w, win))
        assert tg.relation_pairs(seq_t, 6) == jg.relation_pairs(seq_j, 6)
        assert np.array_equal(tg.occurrence_index(seq_t),
                              jg.occurrence_index(seq_j))
        m = r_t.mask
        np.testing.assert_allclose(
            tg.dag_shape_features(r_t.hint_ids[m], a_t.arrival[m],
                                  r_t.arrival[m]),
            jg.dag_shape_features(r_j.hint_ids[m], a_j.arrival[m],
                                  r_j.arrival[m]), rtol=RTOL, atol=ATOL)
    for args in ((3, 0, 9, 1), (31, 2, 0, 0)):
        assert tg.pair_bit(*args) == jg.pair_bit(*args)
    for hint in ("10.0.0.1->10.0.0.2:m1", "", "NopEvent:n0"):
        assert tg.hint_bucket(hint, H) == jg.hint_bucket(hint, H)
    docs = [{"t": {"dispatched": 3.0 - i * 0.5}, "hint": f"h{i % 4}"}
            for i in range(6)] + [{"kind": "gen", "t": {"dispatched": 0}}]
    assert np.array_equal(tg.bucket_sequence_from_docs(docs, H),
                          jg.bucket_sequence_from_docs(docs, H))


@pytest.mark.parametrize("width,window", [(4096, 16), (256, 3)])
def test_coverage_map_equals_the_reference(both_views, width, window):
    port, ref = both_views
    tm = tg.CoverageMap(H=H, width=width, window=window)
    jm = jg.CoverageMap(H=H, width=width, window=window)
    for (_, r_t, _, _), (_, r_j, _, _) in zip(port, ref):
        assert tm.observe(tg.bucket_sequence_from_encoded(r_t)) == \
            jm.observe(jg.bucket_sequence_from_encoded(r_j))
    assert tm.bits_list() == jm.bits_list()
    assert tm.one_sided(top=10) == jm.one_sided(top=10)
    assert tm.stats() == jm.stats()
    bias = tm.mutation_bias()
    assert np.array_equal(bias, jm.mutation_bias())
    assert bias.dtype == np.float32 and bias.max() > 1.0
    seq = tg.bucket_sequence_from_encoded(port[0][0])
    assert tm.predicted_gain(seq[::-1]) == jm.predicted_gain(seq[::-1])
    fleet = list(range(0, width, 7))
    assert tm.merge_bits(fleet) == jm.merge_bits(fleet)
    assert tm.bits_list() == jm.bits_list()


# -- the guided search --------------------------------------------------------


def guided_pair(surrogate_topk=8, **kw):
    js = jsearch.ScheduleSearch(jax_cfg(surrogate_topk=surrogate_topk, **kw),
                                n_devices=1)
    ts = tsearch.ScheduleSearch(port_cfg(surrogate_topk=surrogate_topk,
                                         **kw), device="cpu")
    return js, ts


def test_ingested_guidance_feats_equal_the_reference(storage):
    from namazu_tpu.storage import load_storage as jload

    js, ts = guided_pair()
    kw = dict(H=H, max_interval=0.05, guidance=True)
    want = jingest.ingest_history(js, jload(storage.dir),
                                  jingest.IngestParams(**kw))
    got = tingest.ingest_history(ts, history.load_storage(storage.dir),
                                 tingest.IngestParams(**kw))
    assert len(got) == len(want)
    assert ts.guidance_feats.shape == js.guidance_feats.shape == (16, G)
    np.testing.assert_allclose(ts.guidance_feats, js.guidance_feats,
                               rtol=RTOL, atol=ATOL)
    assert ts.guidance.bits_list() == js.guidance.bits_list()
    assert np.array_equal(ts.guidance.mutation_bias(),
                          js.guidance.mutation_bias())
    tf, tl = ts.labeled_archive()
    jf, jl = js.labeled_archive()
    assert tf.shape == jf.shape == (12, K + G)
    assert np.array_equal(tl, jl)
    np.testing.assert_allclose(tf, jf, rtol=RTOL, atol=ATOL)
    assert ts._surrogate_input_dims() == js._surrogate_input_dims() == K + G
    # a repeated ingest rebuilds the map instead of accumulating it
    runs = ts.guidance.runs_observed
    tingest.ingest_history(ts, history.load_storage(storage.dir),
                           tingest.IngestParams(**kw))
    assert ts.guidance.runs_observed == runs == 12


def test_live_rewire_drops_the_old_width(storage):
    """Guidance wired onto a live search: a K-wide surrogate and archive
    rows without fragments are dropped, as in the reference."""
    from namazu_tpu.storage import load_storage as jload

    js, ts = guided_pair()
    jingest.ingest_history(js, jload(storage.dir),
                           jingest.IngestParams(H=H, max_interval=0.05))
    tingest.ingest_history(ts, history.load_storage(storage.dir),
                           tingest.IngestParams(H=H, max_interval=0.05))
    assert ts._train_surrogate() is not None
    assert js._train_surrogate() is not None
    for s in (ts, js):
        s.enable_guidance()
        assert s._surrogate is None and s._archive_n == 0
        assert s.guidance_feats.shape == (16, G)
    assert torch.equal(ts._dev_archive, torch.from_numpy(ts.archive))
    old = ts.guidance
    assert ts.enable_guidance() is old  # idempotent
    wide = ts.enable_guidance(width=1024)
    assert wide is not old and wide.width == 1024  # another space
    assert ts.enable_guidance(width=1024, fresh=True) is not wide


def carried_pair(storage, tmp_path, runs_guided=True):
    """The reference's guided search after an ingest and 3 generations,
    saved; a fresh reference search and a port search load it (fresh
    optimizers both) and observe the same history into fresh maps."""
    from namazu_tpu.storage import load_storage as jload

    src, _ = guided_pair()
    refs_j = jingest.ingest_history(
        src, jload(storage.dir),
        jingest.IngestParams(H=H, max_interval=0.05, guidance=runs_guided))
    src.run(refs_j, generations=3)
    path = str(tmp_path / "guided.npz")
    src.save(path)
    js, ts = guided_pair()
    for s in (js, ts):
        # a sparse map, so candidates' predicted gains are not all 0
        s.enable_guidance(width=1 << 16)
        s.load(path)
    for (_, r_t, _, _), (_, r_j, _, _) in zip(
            realized_views(storage.dir, tte, history.load_storage),
            realized_views(storage.dir, jte, jload)):
        ts.guidance.observe(tg.bucket_sequence_from_encoded(r_t))
        js.guidance.observe(jg.bucket_sequence_from_encoded(r_j))
    refs_t = tingest.ingest_history(
        tsearch.ScheduleSearch(port_cfg(), device="cpu"),
        history.load_storage(storage.dir),
        tingest.IngestParams(H=H, max_interval=0.05))
    return js, ts, refs_j, refs_t, path


def test_candidate_guidance_equals_the_reference(storage, tmp_path):
    js, ts, refs_j, refs_t, _ = carried_pair(storage, tmp_path)
    delays = np.asarray(js._state.pop.delays)[:12]
    gt, ft = ts._candidate_guidance(delays, refs_t)
    gj, fj = js._candidate_guidance(delays, refs_j)
    assert gt.shape == (12,) and ft.shape == (12, G)
    np.testing.assert_allclose(gt, gj, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ft, fj, rtol=RTOL, atol=ATOL)
    assert gt.max() > 0


@pytest.mark.parametrize("scorer", ["fitness", "local", "remote"])
def test_guided_pick_is_the_reference_s(storage, tmp_path, scorer):
    """The guided re-rank on the same population (a reference
    checkpoint): with no surrogate (the top-k's normalized fitness), with
    the carried local surrogate retrained on both sides, or with a
    remote surrogate; each plus the coverage bonus, and the port picks
    the reference's winner."""
    js, ts, refs_j, refs_t, _ = carried_pair(storage, tmp_path)
    if scorer != "local":
        for s in (js, ts):
            s.archive_labels[:] = 0.0  # one class only: no local model
            s._surrogate = None
    if scorer == "remote":
        for s in (js, ts):
            s.remote_surrogate = lambda f: np.asarray(
                f[:, :K].mean(1) - f[:, K:].mean(1), np.float32)
    _, trace, pairs, archive, failures = js._device_inputs(refs_j)
    nov = jnp.asarray(js.novelty_scale(), jnp.float32)
    want = js._surrogate_pick(trace, pairs, archive, failures, nov,
                              encs=refs_j)
    got = ts._surrogate_pick(*ts._device_inputs(refs_t), ts.novelty_scale(),
                             encs=refs_t)
    assert want is not None and got is not None
    assert (ts._surrogate is not None) == (scorer == "local")
    assert np.array_equal(got.delays, want.delays)
    np.testing.assert_allclose(got.fitness, want.fitness, rtol=RTOL,
                               atol=ATOL)


def test_unguided_remote_outage_keeps_the_fitness_argmax():
    ts = tsearch.ScheduleSearch(port_cfg(surrogate_topk=4), device="cpu")
    calls = []
    ts.remote_surrogate = lambda f: calls.append(f.shape) or None
    encs = [tte.encode_event_stream([f"h{i % 7}" for i in range(40)],
                                    H=H)]
    best = ts.run(encs, generations=2)
    assert calls == [(4, K)]
    assert best.fitness == ts.best().fitness


def test_guided_populations_equal_the_reference_given_its_draws(
        storage, tmp_path):
    """One generation of the island step with the map's mutation bias
    (entries above 1) on the reference's state, fed the reference's
    draws: the populations are equal exactly."""
    js, ts, refs_j, refs_t, _ = carried_pair(storage, tmp_path)
    bias = js.guidance.mutation_bias()
    assert bias.max() > 1 and np.array_equal(bias,
                                             ts.guidance.mutation_bias())
    _, trace, pairs, archive, failures = js._device_inputs(refs_j)
    step = make_multiaxis_island_step(js.mesh, js.cfg.ga, js.cfg.weights,
                                      rings=js._rings)
    want = step(js._state, js._key, trace, pairs, archive, failures, None,
                jnp.asarray(1.0, jnp.float32), jnp.asarray(bias))
    key = jax.random.fold_in(jax.random.fold_in(js._key, int(js._state.gen)),
                             0)
    conv = convert.state_from_jax(jax_arrays(js), "cpu")
    got, _ = tisl.island_step(
        conv.state, 0, port_traces(refs_t), torch.from_numpy(conv.pairs),
        torch.from_numpy(conv.archive), torch.from_numpy(conv.failures),
        tga.GAConfig(*js.cfg.ga), tsched.ScoreWeights(*js.cfg.weights),
        mutation_bias=torch.from_numpy(bias),
        draws=jax_draws(key, 64, H, js.cfg.ga))
    assert np.array_equal(got.pop.delays.numpy(), np.asarray(want.pop.delays))
    unbiased, _ = tisl.island_step(
        conv.state, 0, port_traces(refs_t), torch.from_numpy(conv.pairs),
        torch.from_numpy(conv.archive), torch.from_numpy(conv.failures),
        tga.GAConfig(*js.cfg.ga), tsched.ScoreWeights(*js.cfg.weights),
        draws=jax_draws(key, 64, H, js.cfg.ga))
    assert not torch.equal(unbiased.pop.delays, got.pop.delays)


def test_guided_run_biases_the_fused_and_stepwise_paths(storage):
    """A guided run() hands the map's bias to the GA: fused == stepwise
    bit for bit with it, and the population differs from an unbiased
    run of the same state."""
    out = {}
    for name, fused, guided in (("fused", True, True),
                                ("step", False, True),
                                ("plain", True, False)):
        s = tsearch.ScheduleSearch(port_cfg(fused=fused, fused_chunk=2),
                                   device="cpu")
        refs = tingest.ingest_history(
            s, history.load_storage(storage.dir),
            tingest.IngestParams(H=H, max_interval=0.05, guidance=True))
        if not guided:
            s.guidance = None
        s.run(refs, generations=5)
        out[name] = s._state.pop.delays
    assert torch.equal(out["fused"], out["step"])
    assert not torch.equal(out["fused"], out["plain"])


# -- checkpoints -------------------------------------------------------------


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_guidance_feats_checkpoints_load_both_ways(storage, tmp_path,
                                                   writer):
    from namazu_tpu.storage import load_storage as jload

    js, ts = guided_pair()
    kw = dict(H=H, max_interval=0.05, guidance=True)
    if writer == "reference":
        src = js
        refs = jingest.ingest_history(js, jload(storage.dir),
                                      jingest.IngestParams(**kw))
    else:
        src = ts
        refs = tingest.ingest_history(ts, history.load_storage(storage.dir),
                                      tingest.IngestParams(**kw))
    src.run(refs, generations=2)  # trains the [K | G] surrogate
    path = str(tmp_path / "c.npz")
    src.save(path)
    with np.load(path) as z:
        assert z["guidance_feats"].shape == (16, G)
        assert z["surrogate_params"].size == (K + G) * 128 + 128 \
            + 128 * 64 + 64 + 64 + 1
    dst_j, dst_t = guided_pair()
    for dst in (dst_j, dst_t):
        dst.enable_guidance()
        dst.load(path)
        np.testing.assert_allclose(dst.guidance_feats, src.guidance_feats,
                                   rtol=0, atol=0)
        assert dst._archive_n == src._archive_n
    assert dst_t._surrogate is not None and dst_t._surrogate.K == K + G
    # an unguided port search keeps the archive and retrains the surrogate
    plain = tsearch.ScheduleSearch(port_cfg(surrogate_topk=8), device="cpu")
    plain.load(path)
    assert plain.guidance_feats is None and plain._surrogate is None
    assert plain._archive_n == src._archive_n


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_pre_guidance_checkpoint_drops_the_archive(storage, tmp_path,
                                                   writer):
    from namazu_tpu.storage import load_storage as jload

    js, ts = guided_pair()
    if writer == "reference":
        jingest.ingest_history(js, jload(storage.dir),
                               jingest.IngestParams(H=H))
        src = js
    else:
        tingest.ingest_history(ts, history.load_storage(storage.dir),
                               tingest.IngestParams(H=H))
        src = ts
    path = str(tmp_path / "pre.npz")
    src.save(path)
    assert src._archive_n == 12
    dst_j, dst_t = guided_pair()
    for dst in (dst_j, dst_t):
        dst.enable_guidance()
        dst.load(path)
        assert dst._archive_n == 0 and not dst.archive_labels.any()
        assert (dst.archive == 0.5).all()
    refs = tingest.ingest_history(
        dst_t, history.load_storage(storage.dir),
        tingest.IngestParams(H=H, max_interval=0.05, guidance=True))
    assert refs and dst_t._archive_n == 12


def test_widened_surrogate_weights_convert_both_ways():
    """[K | G] surrogate weights: the port's state_dict -> the
    reference's flat vector -> back, and a flat vector of another width
    raises (the search then retrains)."""
    from jax.flatten_util import ravel_pytree

    from namazu_tpu.models.surrogate import RewardSurrogate as JSur
    from namazu_tpu_torch.models.surrogate import RewardSurrogate as TSur

    jsur = JSur(K=K + G, seed=4)
    vec, _ = ravel_pytree(jsur.state.params)
    state = convert.surrogate_state_from_flat(np.asarray(vec), K + G)
    tsur = TSur(K=K + G, device="cpu")
    tsur.load_state_dict(state)
    x = np.random.RandomState(0).rand(6, K + G).astype(np.float32)
    np.testing.assert_allclose(tsur.predict(x), np.asarray(jsur.predict(x)),
                               rtol=RTOL, atol=ATOL)
    assert np.array_equal(convert.surrogate_flat_from_state(
        tsur.state_dict()), np.asarray(vec))
    with pytest.raises(ValueError):
        convert.surrogate_state_from_flat(np.asarray(vec), K)
