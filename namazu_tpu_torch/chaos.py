"""The chaos seam: the port's counterpart of ``namazu_tpu.chaos.decide``,
which the reference's knowledge client and atomic writes consult at
their fault points.

The port imports nothing of the reference, so its seams ask a *decider*:
any callable that takes a point's name and returns ``None`` (do not
fire) or a dict (fire, with the rule's payload). None is set by default,
and then :func:`decide` is one global read and a ``None`` check, what
the reference's ``decide`` costs with no plan installed. A caller that
runs the reference's chaos plane hands in ``namazu_tpu.chaos.decide``
(both shims do), which reads the reference's installed plan at each
call, so a plan from ``chaos.install`` or ``NMZ_CHAOS`` fires in the
port's seams too.

The points, where they are consulted, in the reference's order:

* ``knowledge.eof`` (``knowledge/client.py``, ``_roundtrip``): after a
  request frame is written; the client drops the socket and takes its
  one transparent retry;
* ``knowledge.outage`` (``knowledge/client.py``, ``_request``): after the
  cooldown check, before the round trip; the client cools down;
* ``storage.tear``, ``storage.fsync``, ``storage.rename``
  (``utils/atomic.py``, ``atomic_write``): before the write, before the
  fsync, before the rename. The failure pool's entry writes skip them,
  as the reference's pool writes do.

The seam keeps no state: the decider is called from every thread that
reaches a point (the sidecar serves each connection on its own), so it
must lock itself, as the reference's ``FaultPlan`` does.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

Decider = Callable[[str], Optional[Dict[str, Any]]]

_decider: Optional[Decider] = None


def set_decider(decider: Decider) -> None:
    """Have every seam of the process consult ``decider``."""
    global _decider
    _decider = decider


def clear_decider() -> None:
    """Back to no decider: every seam a no-op."""
    global _decider
    _decider = None


def decide(point: str) -> Optional[Dict[str, Any]]:
    """Consult the decider at ``point``: ``None`` = do not fire."""
    d = _decider
    if d is None:
        return None
    return d(point)
