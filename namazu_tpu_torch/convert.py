"""Carrying search state between the reference and the port.

The reference's ``ScheduleSearch`` saves its state as numpy arrays under
fixed ``.npz`` keys (``pop_delays``, ``pop_faults``, ``gen``,
``best_fitness``, ``best_delays``, ``best_faults``, ``archive``,
``failures``, ``pairs``, ``archive_n``, ``failure_n``). These functions
map those arrays to the port's :class:`IslandState` and archives and back;
the port's ``ScheduleSearch.save``/``load`` use them, and so do the tests.
"""

from __future__ import annotations

from typing import Mapping, NamedTuple, Optional

import numpy as np
import torch

from namazu_tpu_torch.device import DeviceLike, resolve_device
from namazu_tpu_torch.models.ga import Population
from namazu_tpu_torch.parallel.islands import IslandState


class SearchArrays(NamedTuple):
    state: IslandState
    pairs: Optional[np.ndarray]  # int32[K, 2]; None in old checkpoints
    archive: np.ndarray  # f32[A, K]
    archive_n: int
    failures: np.ndarray  # f32[F, K]
    failure_n: int


def state_from_jax(arrays: Mapping[str, np.ndarray],
                   device: DeviceLike = "cuda") -> SearchArrays:
    """The reference search's numpy arrays -> the port's state on
    ``device``."""
    dev = resolve_device(device)

    def f32(name):
        return torch.tensor(np.asarray(arrays[name], np.float32), device=dev)

    state = IslandState(
        pop=Population(f32("pop_delays"), f32("pop_faults")),
        gen=int(arrays["gen"]),
        best_fitness=f32("best_fitness").reshape(()),
        best_delays=f32("best_delays"),
        best_faults=f32("best_faults"),
    )
    pairs = arrays.get("pairs")
    return SearchArrays(
        state=state,
        pairs=None if pairs is None else np.asarray(pairs, np.int32),
        archive=np.array(arrays["archive"], np.float32),
        archive_n=int(arrays["archive_n"]),
        failures=np.array(arrays["failures"], np.float32),
        failure_n=int(arrays["failure_n"]),
    )


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
