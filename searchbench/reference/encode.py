"""The plain reading of a naive storage: runs as arrays.

Written from the storage format and the search plane's stated encoding,
with NumPy alone. A run is visible when its ``result.json`` exists and no
``INCOMPLETE`` marker sits beside it; runs stamped with another hint
space are left out. Each action's hint is its cause event's replay hint
(or ``<cause class>:<entity>`` when it has none), hashed with 64-bit
FNV-1a into ``H`` buckets. A run has two time views: the arrival view
stamps each event at its cause event's arrival, the realized view at its
release; each view falls back to the other's time where one is missing,
and to index spacing of 1 ms where both are; times are float32 offsets
from the view's earliest stamp.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, NamedTuple, Optional

import numpy as np

FNV_OFFSET = 0xCBF29CE484222325
FNV_PRIME = 0x100000001B3
HINT_SPACE = "flow-v2"


def fnv1a64(data: bytes) -> int:
    h = FNV_OFFSET
    for b in data:
        h = ((h ^ b) * FNV_PRIME) & 0xFFFFFFFFFFFFFFFF
    return h


class Run(NamedTuple):
    """One visible run: bucket, entity index and both time views of its
    first ``L`` events, and its outcome."""

    buckets: np.ndarray  # int64[L]
    entities: np.ndarray  # int64[L]
    arrival: np.ndarray  # float32[L]
    realized: np.ndarray  # float32[L]
    ok: bool


class Reader:
    """Runs of storages, hashed with one memo of hint -> bucket."""

    def __init__(self, H: int):
        self.H = H
        self._buckets: Dict[str, int] = {}

    def bucket(self, hint: str) -> int:
        b = self._buckets.get(hint)
        if b is None:
            b = self._buckets[hint] = fnv1a64(hint.encode()) % self.H
        return b

    def run(self, storage: str, i: int, cap: Optional[int]) -> Optional[Run]:
        """Run ``i`` of ``storage`` (None when invisible or stamped with
        another hint space), its first ``cap`` events when ``cap``."""
        d = os.path.join(storage, f"{i:08x}")
        result = os.path.join(d, "result.json")
        if (not os.path.exists(result)
                or os.path.exists(os.path.join(d, "INCOMPLETE"))):
            return None
        with open(result) as f:
            res = json.load(f)
        meta = res.get("metadata") or {}
        if meta.get("hint_space", "content-v1") != HINT_SPACE:
            return None
        with open(os.path.join(d, "trace.json")) as f:
            actions = json.load(f)
        return self.encode(actions, bool(res["successful"]), cap)

    def encode(self, actions: List[dict], ok: bool,
               cap: Optional[int]) -> Run:
        arr_t, rel_t = [], []
        for a in actions:
            arrived = a.get("event_arrived") or 0.0
            rel = a.get("triggered_time") or 0.0
            arr_t.append(arrived if arrived else rel)
            rel_t.append(rel if rel else arrived)
        a0 = min((t for t in arr_t if t), default=0.0)
        r0 = min((t for t in rel_t if t), default=0.0)
        n = len(actions) if cap is None else min(len(actions), cap)
        buckets = np.zeros(n, np.int64)
        entities = np.zeros(n, np.int64)
        arrival = np.zeros(n, np.float32)
        realized = np.zeros(n, np.float32)
        ent_index: Dict[str, int] = {}
        for i, a in enumerate(actions[:n]):
            hint = a.get("event_hint") or (
                f"{a.get('event_class') or a['class']}:{a['entity']}")
            buckets[i] = self.bucket(hint)
            entities[i] = ent_index.setdefault(a["entity"], len(ent_index))
            arrival[i] = (arr_t[i] - a0) if arr_t[i] else i * 1e-3
            realized[i] = (rel_t[i] - r0) if rel_t[i] else i * 1e-3
        return Run(buckets, entities, arrival, realized, ok)


def visible_runs(storage: str, n: int) -> List[int]:
    """Indices of the runs a reader of ``storage`` with ``next_run = n``
    counts: up to the last one with a result."""
    last = 0
    for i in range(n):
        if os.path.exists(os.path.join(storage, f"{i:08x}", "result.json")):
            last = i + 1
    return list(range(last))
