"""The search's telemetry seam: the port's counterpart of the calls the
reference search makes into ``namazu_tpu/obs`` (``obs/spans.py``
``search_round``, ``search_progress``, ``scorer_throughput``,
``search_phase``, ``search_device_trace``; ``obs/recorder.py``
``record_generation``).

The port imports nothing of the reference, so a search reports to a
*sink*: any object with the methods of :class:`Telemetry`, set as
``search.telemetry``. The default sink records nothing. A caller that
runs the reference's observability plane (the ``torch_search`` policy
shim) hands the reference's ``obs`` module in as the sink: its functions
carry these names and signatures.

:func:`trace_range` stands in for ``jax.named_scope`` and
``jax.profiler.TraceAnnotation``: a ``torch.profiler.record_function``
range, which shows in a ``torch.profiler`` trace (the ``device_trace_dir``
capture) with the kernels launched inside it, and under
``torch.autograd.profiler.emit_nvtx`` becomes an NVTX range.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch


class Telemetry:
    """The sink a search reports to; every method records nothing."""

    def search_phase(self, phase: str):
        """Context manager around one phase of a search (``encode``,
        ``evolve``, ``host_io``, ``surrogate``, ``extract``; the policy
        adds ``ingest`` and ``install``)."""
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


#: the default sink of every search
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
