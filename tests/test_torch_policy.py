"""The ``torch_search`` policy (namazu_tpu_torch_policy.py over
namazu_tpu_torch/policy/tpu.py) on the CPU, held to the reference's
``tpu_search``: the same knobs build the same configs and meshes, the
same refusals come back word for word, checkpoints interchange, the
installed table re-scores to its fitness under the JAX package's scorer,
the search reports the same metrics to the reference's obs plane, the
policy runs with JAX blocked at import, refuses a missing card at
``load_config``, and serves a campaign through ``cli_main`` end to end.

Sizes as tests/test_tpu_policy.py: population 128, H = 32, L = 64,
K = 32, 6 generations, seed 11. Tolerance rtol 1e-3 / atol 1e-4 (f32
sums in another order)."""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from namazu_tpu import obs
from namazu_tpu.ops import schedule as jsched
from namazu_tpu.ops import trace_encoding as jte
from namazu_tpu.policy import create_policy
from namazu_tpu.policy.plugins import load_policy_plugins
from namazu_tpu.signal import EventAcceptanceAction
from namazu_tpu.storage import new_storage
from namazu_tpu.utils.config import Config
from namazu_tpu.utils.policy_tester import pump_concurrent
from namazu_tpu_torch.history import load_storage
from namazu_tpu_torch.ops import trace_encoding as tte
from namazu_tpu_torch.policy import tpu as tpol
from test_torch_cuda import campaign
from test_torch_sidecar import CKPT_KEYS
from test_tpu_policy import record_run

RTOL, ATOL = 1e-3, 1e-4
PLUGIN = "namazu_tpu_torch_policy"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def params(ckpt="", **extra):
    p = {
        "max_interval": 30, "generations": 6, "population": 128,
        "hint_buckets": 32, "trace_length": 64, "feature_pairs": 32,
        "seed": 11, "checkpoint": ckpt,
    }
    p.update(extra)
    return p


def torch_policy(p, **extra):
    load_policy_plugins(Config({"policy_plugins": [PLUGIN]}))
    pol = create_policy("torch_search")
    pol.load_config(Config({"explore_policy_param": dict(p, platform="cpu",
                                                         **extra)}))
    return pol


def search_with(pol, storage):
    """Start ``pol`` over ``storage`` and wait for its search."""
    pol.set_history_storage(storage)
    pol.start()
    try:
        assert pol.wait_for_search(timeout=180)
    finally:
        pol.shutdown()
    return pol


@pytest.fixture
def history(tmp_path):
    st = new_storage("naive", str(tmp_path / "st"))
    st.create()
    record_run(st, ["a", "b", "a", "c", "b", "a"], successful=True)
    record_run(st, ["b", "a", "c", "a", "b", "c"], successful=False)
    return st


def test_torch_search_installs_schedule_from_history(tmp_path, history):
    ckpt = tmp_path / "search.npz"
    pol = torch_policy(params(str(ckpt)))
    assert pol.device == torch.device("cpu")
    pol.set_history_storage(history)
    try:
        pol.start()
        assert pol.wait_for_search(timeout=180)
        from namazu_tpu_torch.models.search import ScheduleSearch

        assert isinstance(pol._search, ScheduleSearch)
        assert pol._delays.shape == (32,)
        assert (pol._delays >= 0).all()
        assert (pol._delays <= 0.03 + 1e-6).all()
        with np.load(ckpt) as z:
            assert CKPT_KEYS <= set(z.files)
            assert int(z["generations_run"]) == 6
        acts = pump_concurrent(pol, 20, entities=3)
        assert len(acts) == 20
        assert all(isinstance(a, EventAcceptanceAction) for a in acts)
    finally:
        pol.shutdown()


@pytest.mark.parametrize("first", ["tpu_search", "torch_search"])
def test_checkpoints_interchange_with_tpu_search(tmp_path, history, first):
    ckpt = str(tmp_path / "search.npz")

    def policy(name):
        if name == "torch_search":
            return torch_policy(params(ckpt))
        pol = create_policy("tpu_search")
        pol.load_config(Config({"explore_policy_param": params(ckpt)}))
        return pol

    second = "tpu_search" if first == "torch_search" else "torch_search"
    p1 = search_with(policy(first), history)
    installs = []
    p2 = policy(second)
    real = p2._install_tables

    def spy(delays, faults, source):
        installs.append(source)
        real(delays, faults, source)

    p2._install_tables = spy
    search_with(p2, history)
    assert p1._search.generations_run == 6
    assert p2._search.generations_run == 12  # resumed, not restarted
    # the first run's best goes in before the second run's own search
    assert installs[0] == "checkpoint" and installs[-1] == "search"
    with np.load(ckpt) as z:
        assert int(z["generations_run"]) == 12


def test_installed_table_rescored_by_the_reference_scorer(tmp_path,
                                                          history):
    pol = search_with(torch_policy(params()), history)
    search = pol._search
    best = search.best()
    assert np.array_equal(np.asarray(pol._delays, np.float32), best.delays)
    # the references ingest evolves against: the one success, L = 64
    ref = jte.encode_trace(history.get_stored_history(0), L=64, H=32)
    h, _, a, m, f = jte.stack_traces([ref])
    traces = jsched.TraceArrays(hint_ids=jnp.asarray(h),
                                arrival=jnp.asarray(a),
                                mask=jnp.asarray(m))
    fitness, _ = jsched.score_population_multi(
        jnp.asarray(best.delays[None]), traces, jnp.asarray(search.pairs),
        jnp.asarray(search.archive), jnp.asarray(search.failures),
        jsched.ScoreWeights(*search.cfg.weights),
        novelty_scale=jnp.asarray(search.novelty_scale(), jnp.float32))
    np.testing.assert_allclose(float(fitness[0]), best.fitness, rtol=RTOL,
                               atol=ATOL)


def test_ingest_reads_the_campaign_storage_as_the_port_reads_its_dir(
        history):
    """The shim's view of the reference's storage object encodes every
    run exactly as the port's own reader of the same directory."""
    import namazu_tpu_torch_policy as shim

    mine, theirs = shim._History(history), load_storage(history.dir)
    assert mine.nr_stored_histories() == theirs.nr_stored_histories() == 2
    for i in range(2):
        assert mine.get_metadata(i) == theirs.get_metadata(i)
        assert mine.is_successful(i) == theirs.is_successful(i)
        for x, y in zip(tte.encode_trace_views(mine.get_stored_history(i),
                                               H=32),
                        tte.encode_trace_views(theirs.get_stored_history(i),
                                               H=32)):
            for name in ("hint_ids", "entity_ids", "arrival", "mask",
                         "faultable"):
                assert np.array_equal(getattr(x, name), getattr(y, name))


def test_failure_seed_and_remote_surrogate_hook_match_the_reference(
        history):
    from namazu_tpu.knowledge.client import pairs_fingerprint

    ref = create_policy("tpu_search")
    ref.load_config(Config({"explore_policy_param": params()}))
    pol = torch_policy(params())
    failed = history.get_stored_history(1)
    assert ref._failure_seed(failed) is None  # no arrival recorded
    assert pol._failure_seed(failed) is None
    for i, a in enumerate(failed):  # arrivals 0-5 ms before release
        a.event_arrived = a.triggered_time - 0.001 * i
    want = ref._failure_seed(failed)
    assert want is not None and want.any()
    assert np.array_equal(pol._failure_seed(failed), want)

    class Client:
        def predict(self, feats, pairs_fp):
            self.asked = (feats, pairs_fp)
            return None

    client = Client()
    pol._knowledge_client = lambda: client
    search = pol._build_search()
    pol._wire_remote_surrogate(search)
    assert search.remote_surrogate("feats") is None
    assert client.asked == ("feats", pairs_fingerprint(search.pairs))


def _asdict(x):
    if hasattr(x, "_asdict"):
        return {k: _asdict(v) for k, v in x._asdict().items()}
    return x


@pytest.mark.parametrize("knobs", [
    {},
    {"max_fault": 0.1},
    {"release_mode": "reorder", "reorder_window": 40, "reorder_gap": 3},
    {"search_backend": "mcts", "mcts_simulations": 8, "mcts_tree_depth": 4,
     "mcts_levels": 3, "mcts_rollouts": 8},
    {"guidance": True, "guidance_bitmap_width": 512, "guidance_window": 8},
    {"devices": 4},
    {"devices": 4, "dcn_hosts": 2, "dcn_migrate_every": 4},
    {"devices": 8, "dcn_hosts": 2},
], ids=["delay", "faults", "reorder", "mcts", "guidance", "devices",
        "dcn_hosts", "dcn_hosts_8"])
def test_build_search_matches_the_reference(tmp_path, knobs):
    ref = create_policy("tpu_search")
    ref.load_config(Config({"explore_policy_param": params(**knobs)}))
    js = ref._build_search()
    s = torch_policy(params(**knobs))._build_search()
    assert s.telemetry is obs
    assert _asdict(s.cfg) == _asdict(js.cfg)
    assert s.BACKEND == js.BACKEND
    if s.BACKEND == "mcts":
        assert _asdict(s.mcts_cfg) == _asdict(js.mcts_cfg)
    if "devices" in knobs:
        assert s.mesh.axis_names == tuple(js.mesh.axis_names)
        assert s.mesh.shape == dict(js.mesh.shape)
    if knobs.get("guidance"):
        assert (s.guidance.width, s.guidance.window) == \
            (js.guidance.width, js.guidance.window) == (512, 8)


@pytest.mark.parametrize("knobs,message", [
    ({"devices": 1, "dcn_hosts": 2}, "1 devices do not divide into 2 hosts"),
    ({"devices": 4, "dcn_hosts": 3}, "4 devices do not divide into 3 hosts"),
])
def test_refusals_match_the_reference_word_for_word(knobs, message):
    ref = create_policy("tpu_search")
    ref.load_config(Config({"explore_policy_param": params(**knobs)}))
    with pytest.raises(ValueError) as want:
        ref._build_search()
    with pytest.raises(ValueError) as got:
        torch_policy(params(**knobs))._build_search()
    assert str(got.value) == str(want.value) == message


METRIC_KEYS = """
import json
from namazu_tpu.obs import metrics
from namazu_tpu.policy import create_policy
from namazu_tpu.policy.plugins import load_policy_plugins
from namazu_tpu.storage import load_storage
from namazu_tpu.utils.config import Config

load_policy_plugins(Config({"policy_plugins": [PLUGIN]}))
metrics.configure(True)
keys = {}
for name, p in (("tpu_search", PARAMS),
                ("torch_search", dict(PARAMS, platform="cpu"))):
    metrics.reset()
    pol = create_policy(name)
    pol.load_config(Config({"explore_policy_param": p}))
    pol.set_history_storage(load_storage(STORAGE))
    pol.start()
    assert pol.wait_for_search(timeout=180)
    pol.shutdown()
    keys[name] = sorted({(fam["name"], tuple(sorted(s["labels"].items())))
                         for fam in metrics.registry().to_jsonable()["metrics"]
                         for s in fam["samples"]})
print(json.dumps(keys))
"""


def test_search_reports_the_reference_metrics(tmp_path, history):
    """Each metric name with the label sets it holds after a search, by
    either policy. In a fresh interpreter: the registry is global, and a
    thread left behind by another test would write into it."""
    script = (f"PLUGIN = {PLUGIN!r}\nPARAMS = {params()!r}\n"
              f"STORAGE = {history.dir!r}\n" + METRIC_KEYS)
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    keys = {name: {(k, tuple(map(tuple, labels))) for k, labels in v}
            for name, v in got.items()}
    search_metrics = {k for k in keys["tpu_search"]
                      if k[0].startswith(("nmz_search", "nmz_scorer"))}
    assert ("nmz_scorer_schedules_per_sec", (("source", "fused"),)) \
        in search_metrics
    assert ("nmz_search_phase_seconds", (("phase", "host_io"),)) \
        in search_metrics
    assert keys["torch_search"] == keys["tpu_search"]


def test_a_fused_chunk_holds_the_four_ranges():
    from namazu_tpu_torch.parallel.mesh import make_island_mesh

    s = tpol.build_search({"H": 32, "K": 32, "population": 64,
                           "migrate_k": 2, "fused_chunk": 3}, "cpu",
                          mesh=make_island_mesh(2, device="cpu"))
    ref = tte.encode_event_stream([f"n{i % 5}->n{i % 3}" for i in range(40)],
                                  H=32)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        s.run([ref], generations=3)
    names = {e.key: e.count for e in prof.key_averages()}
    for r in ("nmz_score", "nmz_mutate", "nmz_migrate", "nmz_select"):
        assert names.get(r) == 3, (r, names.get(r))
    for phase in ("encode", "evolve", "host_io", "extract"):
        assert f"nmz:{phase}" in names


BLOCK_JAX = """
import importlib.abc, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax"):
            raise ImportError(f"{name} is blocked")
        return None

sys.meta_path.insert(0, Block())
"""


def test_policy_searches_with_jax_blocked(tmp_path, history):
    script = BLOCK_JAX + textwrap.dedent(f"""
        from namazu_tpu.policy import create_policy
        from namazu_tpu.policy.plugins import load_policy_plugins
        from namazu_tpu.storage import load_storage
        from namazu_tpu.utils.config import Config

        load_policy_plugins(Config({{"policy_plugins": ["{PLUGIN}"]}}))
        pol = create_policy("torch_search")
        pol.load_config(Config({{"explore_policy_param":
                                 {params(platform="cpu")!r}}}))
        pol.set_history_storage(load_storage({history.dir!r}))
        pol.start()
        assert pol.wait_for_search(timeout=180)
        pol.shutdown()
        assert pol._delays.shape == (32,)
        assert pol._search.generations_run == 6
        assert not [m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib")]
        print("searched without jax")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "searched without jax" in out.stdout


def test_device_rule_refuses_at_load_config(monkeypatch):
    load_policy_plugins(Config({"policy_plugins": [PLUGIN]}))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for platform in ("", "gpu", "cuda"):
        pol = create_policy("torch_search")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pol.load_config(Config({"explore_policy_param": params(
                platform=platform)}))
    pol = create_policy("torch_search")
    with pytest.raises(ValueError, match="platform 'tpu' is not served"):
        pol.load_config(Config({"explore_policy_param": params(
            platform="tpu")}))


def test_campaign_end_to_end_through_the_cli(tmp_path, capsys):
    """init, two runs recorded under ``random``, then two ``run``s with
    ``explore_policy = "torch_search"`` loaded through ``policy_plugins``
    (on the CPU): the first evolves and checkpoints, the second installs
    that checkpoint's schedule before its own search."""
    campaign(tmp_path, "cpu")
