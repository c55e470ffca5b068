"""Carrying search state between the reference and the port.

The reference's ``ScheduleSearch`` saves its state as numpy arrays under
fixed ``.npz`` keys (``pop_delays``, ``pop_faults``, ``gen``,
``best_fitness``, ``best_delays``, ``best_faults``, ``archive``,
``failures``, ``pairs``, ``archive_n``, ``failure_n``,
``surrogate_params`` once its surrogate has trained, and
``guidance_feats`` with causality guidance wired). These functions
map those arrays to the port's :class:`IslandState`, archives and
surrogate weights and back; the port's ``ScheduleSearch.save``/``load``
use them, and so do the tests.

The population travels flat, ``[P, H]`` in row-major island order, as
the reference saves it from any mesh, so a checkpoint moves between mesh
sizes and layouts with no conversion of its own: the search splits it
over its shards (``parallel/islands.py::shard_population``), or keeps a
fresh population when ``P`` does not fit its islands. The MCTS state
(best tables and the key) does not depend on the mesh.

The surrogate's weights travel in two forms. The reference's live form
is a flax params tree ``{"params": {"Dense_i": {"kernel": [in, out],
"bias": [out]}}}``; the port's is ``SurrogateMLP``'s ``state_dict``
(``dense_i.weight`` is ``[out, in]``). Its checkpoint form is one flat
f32 vector, ``jax.flatten_util.ravel_pytree`` of the tree: leaves in
sorted-key order (``Dense_0/bias``, ``Dense_0/kernel``, ``Dense_1/...``),
each raveled row-major. A guided search's surrogate reads ``[K | G]``
features (``G = GUIDANCE_DIMS``), so its vector is that of an MLP of
input width ``K + G``; :func:`surrogate_state_from_flat` takes the width.
"""

from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Optional

import numpy as np
import torch

from namazu_tpu_torch.device import DeviceLike, resolve_device
from namazu_tpu_torch.models.ga import Population
from namazu_tpu_torch.parallel.islands import IslandState


class Archives(NamedTuple):
    pairs: Optional[np.ndarray]  # int32[K, 2]; None in old checkpoints
    archive: np.ndarray  # f32[A, K]
    archive_n: int
    failures: np.ndarray  # f32[F, K]
    failure_n: int
    # f32[A, G] DAG-shape fragments, slot-aligned with the archive; None
    # without guidance
    guidance_feats: Optional[np.ndarray] = None


class SearchArrays(NamedTuple):
    state: IslandState
    pairs: Optional[np.ndarray]  # int32[K, 2]; None in old checkpoints
    archive: np.ndarray  # f32[A, K]
    archive_n: int
    failures: np.ndarray  # f32[F, K]
    failure_n: int
    guidance_feats: Optional[np.ndarray] = None  # f32[A, G]


def archives_from_jax(arrays: Mapping[str, np.ndarray]) -> Archives:
    """The pairs and archives of a checkpoint of either backend."""
    pairs = arrays.get("pairs")
    gfeats = arrays.get("guidance_feats")
    return Archives(
        pairs=None if pairs is None else np.asarray(pairs, np.int32),
        archive=np.array(arrays["archive"], np.float32),
        archive_n=int(arrays["archive_n"]),
        failures=np.array(arrays["failures"], np.float32),
        failure_n=int(arrays["failure_n"]),
        guidance_feats=(None if gfeats is None
                        else np.array(gfeats, np.float32)),
    )


def island_state_from_jax(arrays: Mapping[str, np.ndarray],
                          device: DeviceLike = "cuda") -> IslandState:
    """The GA state of a reference checkpoint on ``device``."""
    dev = resolve_device(device)

    def f32(name):
        return torch.tensor(np.asarray(arrays[name], np.float32), device=dev)

    return IslandState(
        pop=Population(f32("pop_delays"), f32("pop_faults")),
        gen=int(arrays["gen"]),
        best_fitness=f32("best_fitness").reshape(()),
        best_delays=f32("best_delays"),
        best_faults=f32("best_faults"),
    )


def state_from_jax(arrays: Mapping[str, np.ndarray],
                   device: DeviceLike = "cuda") -> SearchArrays:
    """The reference search's numpy arrays -> the port's state on
    ``device``."""
    return SearchArrays(island_state_from_jax(arrays, device),
                        *archives_from_jax(arrays))


def state_to_jax(state: IslandState) -> dict:
    """The port's island state -> the reference's checkpoint arrays."""
    return {
        "pop_delays": state.pop.delays.cpu().numpy(),
        "pop_faults": state.pop.faults.cpu().numpy(),
        "gen": np.asarray(state.gen, np.int32),
        "best_fitness": np.asarray(float(state.best_fitness), np.float32),
        "best_delays": state.best_delays.cpu().numpy(),
        "best_faults": state.best_faults.cpu().numpy(),
    }


SURROGATE_LAYERS = 3


def surrogate_state_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """A flax params tree (numpy leaves; the ``"params"`` wrapper
    optional) -> the port's ``SurrogateMLP`` state_dict."""
    tree = params.get("params", params)
    out = {}
    for i in range(SURROGATE_LAYERS):
        layer = tree[f"Dense_{i}"]
        out[f"dense_{i}.weight"] = torch.from_numpy(
            np.array(np.asarray(layer["kernel"], np.float32).T, order="C"))
        out[f"dense_{i}.bias"] = torch.from_numpy(
            np.array(layer["bias"], np.float32))
    return out


def surrogate_state_to_flax(state: Mapping[str, torch.Tensor]) -> dict:
    """The port's state_dict -> a flax params tree of numpy arrays."""
    return {"params": {
        f"Dense_{i}": {
            "kernel": np.ascontiguousarray(
                state[f"dense_{i}.weight"].detach().cpu().numpy().T),
            "bias": state[f"dense_{i}.bias"].detach().cpu().numpy(),
        } for i in range(SURROGATE_LAYERS)}}


def surrogate_flat_from_state(state: Mapping[str, torch.Tensor]
                              ) -> np.ndarray:
    """The port's state_dict -> the reference checkpoint's
    ``surrogate_params`` vector (ravel_pytree order)."""
    tree = surrogate_state_to_flax(state)["params"]
    parts = []
    for i in range(SURROGATE_LAYERS):
        parts.append(tree[f"Dense_{i}"]["bias"].reshape(-1))
        parts.append(tree[f"Dense_{i}"]["kernel"].reshape(-1))
    return np.concatenate(parts).astype(np.float32)


def surrogate_state_from_flat(vec: np.ndarray, K: int, hidden: int = 128
                              ) -> Dict[str, torch.Tensor]:
    """A ``surrogate_params`` vector -> the port's state_dict for an MLP of
    input width ``K``; a vector of another size raises ``ValueError``."""
    vec = np.asarray(vec, np.float32).reshape(-1)
    dims = [K, hidden, hidden // 2, 1]
    want = sum(o + i * o for i, o in zip(dims[:-1], dims[1:]))
    if vec.size != want:
        raise ValueError(f"surrogate_params has {vec.size} values; an MLP "
                         f"of width K={K} has {want}")
    tree, at = {}, 0
    for n, (fan_in, fan_out) in enumerate(zip(dims[:-1], dims[1:])):
        bias = vec[at:at + fan_out]
        at += fan_out
        kernel = vec[at:at + fan_in * fan_out].reshape(fan_in, fan_out)
        at += fan_in * fan_out
        tree[f"Dense_{n}"] = {"bias": bias, "kernel": kernel}
    return surrogate_state_from_flax(tree)
