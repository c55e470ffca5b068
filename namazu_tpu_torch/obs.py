"""The telemetry seam: the port's counterpart of the calls the reference's
search, ingest, knowledge client and service, sidecar and framed server
make into ``namazu_tpu/obs`` (``obs/spans.py`` ``search_round``,
``search_progress``, ``scorer_throughput``, ``search_phase``,
``search_device_trace``, ``sidecar_request``, ``wire_bytes``, the
``knowledge_*`` calls, ``triage_dossier_pull``, ``relation_coverage``;
``obs/recorder.py`` ``record_generation``; ``obs/context.py``
``wire_stamp`` and ``observe_wire``, the causality stamps on framed ops;
``obs/federation.py`` ``register_collector`` and
``unregister_collector``).

The port imports nothing of the reference, so each of those reports to a
*sink*: any object with the methods of :class:`Telemetry`, set as
``search.telemetry`` or passed as ``telemetry=``. The default sink
records nothing. A caller that runs the reference's observability plane
hands it in as the sink: both shims (``namazu_tpu_torch_sidecar.py``
and the ``torch_search`` policy shim) the sidecar shim's ``SINK``, which
forwards to the reference's ``obs`` module, whose functions carry these
names and signatures, with the two collector calls of
``obs.federation`` and the two stamp calls of ``obs.context``.

:func:`trace_range` stands in for ``jax.named_scope`` and
``jax.profiler.TraceAnnotation``: a ``torch.profiler.record_function``
range, which shows in a ``torch.profiler`` trace (the ``device_trace_dir``
capture) with the kernels launched inside it, and under
``torch.autograd.profiler.emit_nvtx`` becomes an NVTX range.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch


class Telemetry:
    """The sink the port reports to; every method records nothing."""

    def search_phase(self, phase: str):
        """Context manager around one phase of a search (``encode``,
        ``evolve``, ``host_io``, ``surrogate``, ``extract``; the policy
        adds ``ingest`` and ``install``), of its ingest (each section,
        ``ingest_read_encode``, ``ingest_pool_io``, ``ingest_knowledge``,
        ``ingest_guidance_observe``, ``ingest_archive``) and, on the
        sidecar's path, ``ingest`` around the whole ingest and ``save``
        around the checkpoint's save."""
        return contextlib.nullcontext()

    def search_round(self, backend: str, generations: int, elapsed: float,
                     schedules: float, best_fitness: float,
                     archive_entries: int, failure_entries: int,
                     distinct_failures: int,
                     host_io_s: Optional[float] = None) -> None:
        """One ``run()``: generations (MCTS: simulations), evolve seconds,
        schedules scored, best fitness and archive occupancies."""

    def record_generation(self, backend: str, generations: int,
                          elapsed: float, best_fitness: float,
                          now: Optional[float] = None,
                          archive_entries: Optional[int] = None,
                          failure_entries: Optional[int] = None,
                          distinct_failures: Optional[int] = None,
                          host_io_s: Optional[float] = None,
                          fit_curve: Optional[list] = None) -> None:
        """The same round for the flight recorder, with the fused loop's
        per-generation best-fitness curve."""

    def scorer_throughput(self, source: str, rate: float) -> None:
        """Schedules scored per second by the fused loop."""

    def search_progress(self, backend: str, best_fitness: float) -> None:
        """Best fitness so far, published once per drained chunk."""

    def search_device_trace(self, path: str) -> None:
        """A completed device-trace capture written under ``path``."""

    def sidecar_request(self, op: str, ok: bool) -> None:
        """One request the sidecar answered, by op and outcome."""

    def wire_bytes(self, codec: str, op: str, n: int) -> None:
        """``n`` bytes of one framed request and its answer, by codec
        and op."""

    def knowledge_push(self, ok: bool, accepted: int = 0,
                       duplicates: int = 0) -> None:
        """One ``pool_push`` round trip of a knowledge client: entries
        the service newly stored and those it already held."""

    def knowledge_pull(self, ok: bool) -> None:
        """One ``pool_pull`` round trip of a knowledge client."""

    def knowledge_outage(self) -> None:
        """The knowledge service was unreachable or refused an op; the
        client degraded to local-only search."""

    def knowledge_warmstart(self, kind: str, n: int = 1) -> None:
        """``n`` pieces of fleet knowledge installed by an ingest
        (``archive``: pooled signatures new to the search; ``coverage``:
        pooled coverage bits new to its map)."""

    def knowledge_surrogate_round(self) -> None:
        """One fit round of a shared surrogate on the knowledge
        service."""

    def knowledge_service_stats(self, tenants: int,
                                pool_entries: int) -> None:
        """The knowledge service's tenants and pooled signatures."""

    def knowledge_fanin(self, inflight: int,
                        lock_wait_s: Optional[float] = None) -> None:
        """Requests inside the knowledge service's handler, and (as one
        enters its state lock) how long it waited for the lock."""

    def triage_dossier_pull(self, ok: bool) -> None:
        """One dossier fetch of a knowledge client; ``ok``: a dossier
        came back."""

    def relation_coverage(self, scenario: str, covered: int, width: int,
                          one_sided: Optional[int] = None) -> None:
        """A campaign's coverage map after ingest: bits covered of
        ``width``, and the relations seen in one direction only."""

    def wire_stamp(self) -> Optional[dict]:
        """A causality stamp (``{"lc", "o"}``: the sender's Lamport clock,
        ticked, and its identity) for an op frame or a response, or
        ``None`` to send none: the frame then stays as it was before
        stamps."""
        return None

    def observe_wire(self, ctx) -> None:
        """Merge a peer's stamp (the ``ctx`` of a frame) into the clock."""

    def register_collector(self, fn: Callable[[], None]) -> None:
        """Have ``fn`` refresh sampled gauges before each push and each
        ``metrics`` read."""

    def unregister_collector(self, fn: Callable[[], None]) -> None:
        """Undo :meth:`register_collector`."""


#: the default sink of every search, client, service and sidecar
NULL = Telemetry()


def trace_range(name: str):
    """A named range in any ``torch.profiler`` capture (an NVTX range
    under ``emit_nvtx``); costs a few microseconds with no profiler on."""
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def search_phase(sink, phase: str):
    """``sink.search_phase(phase)`` inside a ``nmz:<phase>`` range."""
    with sink.search_phase(phase), trace_range(f"nmz:{phase}"):
        yield
