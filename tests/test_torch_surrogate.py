"""The port's reward surrogate (namazu_tpu_torch/models/surrogate.py) and
its weight carry-across (convert.py) held to the reference's flax/optax
RewardSurrogate, and surrogate checkpoints interchanged both ways through
the two packages' ScheduleSearch.

Tolerances: carried weights give the same logits within atol 1e-5 (one
f32 matmul chain summed in another order; observed 7e-8). After 4 epochs
of Adam on the same data, order and weights, logits agree within atol
1e-4 (observed 7.7e-6 at K=32 and 6.4e-6 at K=256 on logits of magnitude
~1). Checkpoint round trips are exact (f32 vectors copied)."""

import numpy as np
import pytest
import torch

import jax
from jax.flatten_util import ravel_pytree

from namazu_tpu.models import search as jsearch
from namazu_tpu.models.surrogate import RewardSurrogate as JSurrogate
from namazu_tpu.ops import trace_encoding as jte
from namazu_tpu_torch import convert
from namazu_tpu_torch.models import search as tsearch
from namazu_tpu_torch.models.surrogate import RewardSurrogate
from namazu_tpu_torch.ops import trace_encoding as tte
from test_torch_search import K, jax_cfg, label_archive, port_cfg, refs

LOGIT_ATOL = 1e-5
TRAINED_ATOL = 1e-4


def numpy_params(j: JSurrogate):
    return jax.tree_util.tree_map(np.asarray, j.state.params)


def carried(j: JSurrogate, K: int) -> RewardSurrogate:
    t = RewardSurrogate(K=K, seed=99, device="cpu")
    t.load_state_dict(convert.surrogate_state_from_flax(numpy_params(j)))
    return t


def data(K, n, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, K).astype(np.float32)
    y = (rng.rand(n) < 0.3).astype(np.float32)
    return x, y, rng.rand(64, K).astype(np.float32)


def ref_logits(j: JSurrogate, x):
    return np.asarray(j.model.apply(j.state.params, x))


@pytest.mark.parametrize("K_", [32, 256])
def test_flax_params_carried_across_give_the_same_logits(K_):
    j = JSurrogate(K=K_, seed=4)
    t = carried(j, K_)
    _, _, q = data(K_, 1)
    np.testing.assert_allclose(t.logits(q), ref_logits(j, q), rtol=0,
                               atol=LOGIT_ATOL)
    np.testing.assert_allclose(t.predict(q), np.asarray(j.predict(q)),
                               rtol=0, atol=LOGIT_ATOL)
    back = convert.surrogate_state_to_flax(t.state_dict())
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(numpy_params(j))):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("K_,n", [(32, 300), (256, 512)])
def test_four_epochs_of_training_stay_within_bound(K_, n):
    j = JSurrogate(K=K_, seed=2)
    t = carried(j, K_)
    x, y, q = data(K_, n)
    before = ref_logits(j, q)
    lj = j.train(x, y, epochs=4, seed=11)
    lt = t.train(x, y, epochs=4, seed=11)
    assert t.steps == 4 * -(-n // 256)
    np.testing.assert_allclose(lt, lj, rtol=0, atol=TRAINED_ATOL)
    after = ref_logits(j, q)
    assert np.abs(after - before).max() > 0.1  # training moved the model
    np.testing.assert_allclose(t.logits(q), after, rtol=0,
                               atol=TRAINED_ATOL)
    order_t, _ = t.rerank(q, top=5)
    order_j, _ = j.rerank(q, top=5)
    assert np.array_equal(order_t, order_j)


def test_flat_vector_is_ravel_pytree_order():
    j = JSurrogate(K=K, seed=6)
    vec, unravel = ravel_pytree(j.state.params)
    t = carried(j, K)
    flat = convert.surrogate_flat_from_state(t.state_dict())
    assert flat.dtype == np.float32 and np.array_equal(flat, np.asarray(vec))
    state = convert.surrogate_state_from_flat(flat, K)
    for k, v in t.state_dict().items():
        assert torch.equal(state[k], v)
    # and the reference's unravel of the port's vector is the same tree
    for a, b in zip(jax.tree_util.tree_leaves(unravel(flat)),
                    jax.tree_util.tree_leaves(j.state.params)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    with pytest.raises(ValueError, match="K=40"):
        convert.surrogate_state_from_flat(flat, 40)


def test_fresh_weights_follow_flax_dense_defaults():
    a = RewardSurrogate(K=256, seed=1, device="cpu").state_dict()
    b = RewardSurrogate(K=256, seed=1, device="cpu").state_dict()
    c = RewardSurrogate(K=256, seed=2, device="cpu").state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["dense_0.weight"], c["dense_0.weight"])
    ref = numpy_params(JSurrogate(K=256, seed=1))["params"]
    for i, fan_in in enumerate((256, 128, 64)):
        w = a[f"dense_{i}.weight"]
        assert not a[f"dense_{i}.bias"].any()
        limit = 2 * np.sqrt(1.0 / fan_in) / 0.87962566103423978
        assert float(w.abs().max()) <= limit * (1 + 1e-6)
        if w.numel() > 1000:  # same spread as flax's draw, within 5%
            want = np.asarray(ref[f"Dense_{i}"]["kernel"]).std()
            assert abs(float(w.std()) / want - 1) < 0.05


def probe_feats():
    return np.random.RandomState(3).rand(16, K).astype(np.float32)


def test_reference_checkpoint_through_port_and_back(tmp_path):
    js = jsearch.ScheduleSearch(jax_cfg(surrogate_topk=4), n_devices=1)
    label_archive(js, jte)
    js.run(refs(jte), generations=2)
    assert js._surrogate is not None
    want = np.asarray(js._surrogate.predict(probe_feats()))
    a, b = str(tmp_path / "ref.npz"), str(tmp_path / "port.npz")
    js.save(a)

    s = tsearch.ScheduleSearch(port_cfg(surrogate_topk=4), device="cpu")
    s.load(a)
    assert s._surrogate is not None
    np.testing.assert_allclose(s._surrogate.predict(probe_feats()), want,
                               rtol=0, atol=LOGIT_ATOL)
    s.save(b)
    with np.load(a) as za, np.load(b) as zb:
        assert np.array_equal(za["surrogate_params"],
                              zb["surrogate_params"])
        assert np.array_equal(za["archive_labels"], zb["archive_labels"])

    back = jsearch.ScheduleSearch(jax_cfg(surrogate_topk=4), n_devices=1)
    back.load(b)
    np.testing.assert_allclose(
        np.asarray(back._surrogate.predict(probe_feats())), want, rtol=0,
        atol=LOGIT_ATOL)


def test_port_checkpoint_through_reference_and_back(tmp_path):
    s = tsearch.ScheduleSearch(port_cfg(surrogate_topk=4), device="cpu")
    label_archive(s, tte)
    s.run(refs(tte), generations=2)
    assert s._surrogate is not None and s._surrogate.steps == 4
    want = s._surrogate.predict(probe_feats())
    a, b = str(tmp_path / "port.npz"), str(tmp_path / "ref.npz")
    s.save(a)

    js = jsearch.ScheduleSearch(jax_cfg(surrogate_topk=4), n_devices=1)
    js.load(a)
    np.testing.assert_allclose(np.asarray(js._surrogate.predict(
        probe_feats())), want, rtol=0, atol=LOGIT_ATOL)
    np.testing.assert_array_equal(js.archive_labels, s.archive_labels)
    js.save(b)

    back = tsearch.ScheduleSearch(port_cfg(surrogate_topk=4), device="cpu")
    back.load(b)
    np.testing.assert_allclose(back._surrogate.predict(probe_feats()), want,
                               rtol=0, atol=LOGIT_ATOL)


def test_checkpoint_of_another_width_drops_the_surrogate(tmp_path):
    s = tsearch.ScheduleSearch(port_cfg(surrogate_topk=4), device="cpu")
    label_archive(s, tte)
    s.run(refs(tte), generations=1)
    path = str(tmp_path / "c.npz")
    s.save(path)
    with np.load(path) as z:
        arrays = dict(z)
    arrays["surrogate_params"] = arrays["surrogate_params"][:-7]
    np.savez(path, **arrays)
    other = tsearch.ScheduleSearch(port_cfg(surrogate_topk=4), device="cpu")
    other.load(path)
    assert other._surrogate is None  # retrains from the labeled archive
    assert np.array_equal(other.archive_labels, s.archive_labels)
