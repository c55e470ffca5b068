"""The port's driver entry points (namazu_tpu_torch/entry.py) held to the
reference's (__graft_entry__.py): ``entry``'s scorer on the reference
entry's own example arguments (its population is drawn with
``jax.random``, which torch cannot reproduce) within rtol 1e-3 / atol
1e-4 of the reference's function run by JAX on the CPU; the dry runs'
generation counts and the fused one's keys; the device rule and the
placement of islands on cards."""

import ast
import pathlib

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
from namazu_tpu_torch import entry as tentry
from namazu_tpu_torch.parallel import islands as tisl
from namazu_tpu_torch.parallel.mesh import IslandMesh, make_topology_mesh

RTOL, ATOL = 1e-3, 1e-4
REPO = pathlib.Path(__file__).resolve().parents[1]


def reference_result_keys():
    """The keys of the dict the reference's ``dryrun_multichip_fused``
    returns, read from its source (running it needs 16 JAX devices)."""
    tree = ast.parse((REPO / "__graft_entry__.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "dryrun_multichip_fused")
    result = next(n.value for n in ast.walk(fn) if isinstance(n, ast.Assign)
                  and getattr(n.targets[0], "id", "") == "result")
    return [k.value for k in result.keys]


@pytest.mark.parametrize("archives", ["example", "random"])
def test_entry_matches_the_reference_on_its_example_args(archives):
    """On the example archives (all 0.5) novelty and bug distance cancel;
    random ones, the same on both sides, make each count."""
    jfn, jargs = jentry.entry()
    jargs = [np.array(a) for a in jargs]
    if archives == "random":
        rng = np.random.RandomState(0)
        jargs[5] = rng.rand(*jargs[5].shape).astype(np.float32)
        jargs[6] = rng.rand(*jargs[6].shape).astype(np.float32)
    want = np.asarray(jax.jit(jfn)(*jargs))
    fn, _ = tentry.entry("cpu")
    got = fn(*(torch.from_numpy(a) for a in jargs))
    assert got.shape == want.shape == (1024,)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_entry_builds_the_reference_inputs():
    """Everything but the population equals the reference's example
    arguments exactly; the population has its shape and range."""
    _, jargs = jentry.entry()
    _, args = tentry.entry("cpu")
    assert [tuple(a.shape) for a in args] == [a.shape for a in jargs]
    for got, want in zip(args[1:], jargs[1:]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    delays = args[0].numpy()
    assert delays.dtype == np.float32
    assert 0.0 <= delays.min() and delays.max() <= 0.1
    _, again = tentry.entry("cpu")
    assert torch.equal(again[0], args[0])  # seeded


def test_dryrun_multichip_reaches_the_reference_generations(capsys):
    tentry.dryrun_multichip(8, device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0] for ln in lines] == [
        "dryrun_multichip OK", "dryrun_multichip OK (hybrid)"]
    assert "8-device mesh, population 64" in lines[0]
    assert "2x4 host-chip mesh" in lines[1]


def test_dryrun_multichip_fused_returns_the_reference_keys(monkeypatch):
    gens = []
    real = tisl.fused_step

    def counted(*a, **kw):
        state, hist = real(*a, **kw)
        gens.append(state.gen)
        return state, hist

    monkeypatch.setattr(tentry, "fused_step", counted)
    res = tentry.dryrun_multichip_fused(16, device="cpu")
    assert list(res) == reference_result_keys()
    assert res["ok"] is True
    assert (res["n_devices"], res["mesh"], res["population"],
            res["generations_per_dispatch"], res["dcn_every"]) == \
        (16, "4x4", 1024, 8, 4)
    # 1 + 3 dispatches of 8 generations on the mesh, then on one island
    assert gens == [8, 16, 24, 32] * 2
    assert res["overhead_factor"] > 0 and np.isfinite(res["best_fitness"])


def test_entry_points_need_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (tentry.entry, lambda: tentry.dryrun_multichip(8),
                 tentry.dryrun_multichip_fused):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


@pytest.mark.parametrize("n,cards,want", [
    (8, 1, [0] * 8),
    (8, 4, [0, 0, 1, 1, 2, 2, 3, 3]),
    (6, 4, [0, 0, 1, 1, 2, 2]),
    (16, 4, [c for c in range(4) for _ in range(4)]),
    (2, 8, [0, 1]),
])
def test_islands_share_cards_in_equal_consecutive_groups(monkeypatch, n,
                                                         cards, want):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    got = tentry.island_devices(n, "cuda")
    assert got == [torch.device("cuda", c) for c in want]
    mesh = IslandMesh(("i",), (n,), got)
    assert [s.islands for s in mesh.shards] == [n // len(set(want))] * len(
        set(want))


def test_topology_mesh_over_given_devices():
    devs = tentry.island_devices(16, "cpu")
    mesh = make_topology_mesh(host_size=4, devices=devs)
    assert mesh.shape == {"h": 4, "i": 4}
    assert [(s.start, s.islands) for s in mesh.shards] == [(0, 16)]
    flat = make_topology_mesh(host_size=4, devices=devs[:4])
    assert flat.shape == {"i": 4}
    with pytest.raises(ValueError, match="do not divide"):
        make_topology_mesh(host_size=4, devices=devs[:6])
