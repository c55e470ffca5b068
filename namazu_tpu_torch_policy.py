"""``torch_search``: the ``tpu_search`` policy with its search on the
PyTorch/CUDA port, registered through the reference's ``policy_plugins``
seam.

Select it in an experiment config::

    explore_policy = "torch_search"
    policy_plugins = ["namazu_tpu_torch_policy"]

    [explore_policy_param]
    platform = "cpu"      # "" / "gpu" / "cuda" (the default): the card
    checkpoint = "search.npz"
    # ... every other tpu_search knob, dcn_hosts included

``run`` imports this module before it creates the policy, and the module
registers the policy at import. The policy is ``TPUSearchPolicy`` with
the four places where the reference reaches JAX replaced by the port's
(``namazu_tpu_torch/policy/tpu.py``): building the search, ingesting the
history, a failure's seed table and the shared surrogate's hook. The
search reports to the reference's observability plane
(``namazu_tpu.obs``), and the port's chaos seams (its ingest's knowledge
client: ``knowledge.eof``, ``knowledge.outage``) consult the reference's
``chaos.decide``, so the plan ``run`` installs from ``NMZ_CHAOS`` fires
in them as in the reference's client. Everything else is inherited: the
event-time decisions, the reorder window, the checkpoint-first install
(numpy alone), ``search_every``, the knowledge warm start and push, and
the sidecar branch, whose in-process fallback now runs on the card.
The search and its ingest's knowledge client report to the sidecar
shim's sink (``namazu_tpu_torch_sidecar.SINK``: the reference's ``obs``,
its causality stamps included), and no phase of a ``torch_search``
search imports JAX (``load_config`` turns the reference's
``jax.profiler`` annotation off).

The one departure from the reference's control flow: the device is
resolved when the config loads, so a ``platform`` the port does not serve
(``"tpu"``), or the card without CUDA, raises there instead of leaving
the whole campaign on hash delays.

With ``dcn_hosts > 1`` start one ``run`` per host with
``NMZ_TPU_COORDINATOR=host:port``, ``NMZ_TPU_NUM_PROCESSES`` and
``NMZ_TPU_PROCESS_ID`` set; the processes meet in ``torch.distributed``.

This file and ``namazu_tpu_torch_sidecar.py`` are the port's only files
that import ``namazu_tpu``; neither imports JAX.
"""

from __future__ import annotations

from namazu_tpu import chaos
from namazu_tpu.obs import spans
from namazu_tpu.policy.base import register_policy
from namazu_tpu.policy.tpu import TPUSearchPolicy
from namazu_tpu_torch import chaos as seams
from namazu_tpu_torch.history import ActionRecord
from namazu_tpu_torch.models.ingest import failure_seed, ingest_history
from namazu_tpu_torch.policy.tpu import (
    build_search,
    ingest_params,
    policy_device,
    wire_remote_surrogate,
)
from namazu_tpu_torch_sidecar import SINK


def _records(trace) -> list:
    """A recorded run's actions as the port reads them (the reference's
    ``Action.class_name`` is a method, the port's a field)."""
    return [ActionRecord(
        class_name=a.class_name(), entity_id=a.entity_id,
        event_class=getattr(a, "event_class", "") or "",
        event_hint=getattr(a, "event_hint", "") or "",
        event_arrived=getattr(a, "event_arrived", None),
        triggered_time=a.triggered_time) for a in trace]


class _History:
    """The campaign's ``HistoryStorage`` (any type) as the port's ingest
    reads a storage."""

    def __init__(self, storage):
        self._storage = storage

    def nr_stored_histories(self) -> int:
        return self._storage.nr_stored_histories()

    def get_stored_history(self, i: int) -> list:
        return _records(self._storage.get_stored_history(i))

    def is_successful(self, i: int) -> bool:
        return self._storage.is_successful(i)

    def get_metadata(self, i: int) -> dict:
        return self._storage.get_metadata(i)


class TorchSearchPolicy(TPUSearchPolicy):
    NAME = "torch_search"

    def load_config(self, config) -> None:
        super().load_config(config)
        self.device = policy_device(self.platform, self.n_devices,
                                    self.dcn_hosts)
        # the reference's phase timer annotates jax.profiler when JAX is
        # importable; the port's nmz:<phase> ranges do that here, so take
        # its documented no-JAX fallback (set here, not at import: a run
        # that lists this plugin but picks tpu_search keeps the
        # reference's annotations)
        spans._trace_annotation_cls = False

    def _build_search(self):
        search = build_search(self._search_params(), self.device,
                              dcn_hosts=self.dcn_hosts)
        search.telemetry = SINK
        seams.set_decider(chaos.decide)
        return search

    def _ingest_history(self, search):
        # the ingest reports to search.telemetry, the sidecar shim's sink
        storage = None if self._storage is None else _History(self._storage)
        return ingest_history(search, storage, ingest_params(
            self._ingest_params()._asdict()))

    def _failure_seed(self, trace):
        return failure_seed(_records(trace), self.H, self.max_interval)

    def _wire_remote_surrogate(self, search) -> None:
        wire_remote_surrogate(search, self._knowledge_client())


register_policy(TorchSearchPolicy.NAME, TorchSearchPolicy)
