"""Read-only access to an experiment's recorded history: the port's own
reader of the naive (filesystem JSON) storage that ``namazu_tpu``'s
control plane writes (``namazu_tpu/storage/naive.py``,
``storage/base.py::load_storage``, ``utils/trace.py``).

Layout of a storage directory::

    storage.json          {"type": "naive", "next_run": N}
    00000000/             one directory per run (%08x)
        trace.json        the run's actions, a JSON array of wire dicts
                          with "triggered_time" added
        result.json       {"successful": bool, "required_time": s,
                           "metadata": {...}}
        INCOMPLETE        quarantine marker: the run is invisible

A run with a trace but no result (a crash between the two writes) is
invisible too; the reader never writes a marker or anything else.

``run_tokens`` stats every run for a reader that keeps what it read
between two reads of the storage (``models/ingest.py::RunCache``): a
run's token moves whenever its directory, ``result.json`` or
``trace.json`` is replaced, rewritten or touched, and a marker added to
or taken from the directory moves the directory's times.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

INCOMPLETE_MARKER = "INCOMPLETE"


class StorageError(Exception):
    pass


#: one file's ``(st_ino, st_size, st_mtime_ns, st_ctime_ns)``
Stat = Tuple[int, int, int, int]
#: a run's stat token: its directory's, ``result.json``'s and
#: ``trace.json``'s stats (None for a missing one)
RunToken = Tuple[Optional[Stat], Stat, Optional[Stat]]


def _stat(path: str) -> Optional[Stat]:
    try:
        st = os.stat(path)
    except OSError:
        return None
    return (st.st_ino, st.st_size, st.st_mtime_ns, st.st_ctime_ns)


class ActionRecord(NamedTuple):
    """One recorded action, as much of it as the search plane reads."""

    class_name: str  # the action's signal class ("class")
    entity_id: str  # "entity"
    event_class: str = ""  # the cause event's class
    event_hint: str = ""  # the cause event's replay hint
    event_arrived: Optional[float] = None  # cause event's arrival time
    triggered_time: Optional[float] = None  # when the action released it

    @classmethod
    def from_jsonable(cls, d: Dict[str, Any]) -> "ActionRecord":
        if "class" not in d:
            raise StorageError(f"trace element missing 'class': {d!r}")
        if d.get("type", "action") != "action":
            raise StorageError(f"trace element is not an action: {d!r}")
        tt = d.get("triggered_time")
        return cls(
            class_name=str(d["class"]),
            entity_id=str(d["entity"]),
            event_class=d.get("event_class", "") or "",
            event_hint=d.get("event_hint", "") or "",
            event_arrived=d.get("event_arrived"),
            triggered_time=None if tt is None else float(tt),
        )


class NaiveHistory:
    """One experiment's runs, read from a naive storage directory."""

    NAME = "naive"

    def __init__(self, dir_path: str):
        self.dir = os.path.abspath(dir_path)
        with open(os.path.join(self.dir, "storage.json")) as f:
            self._next_run = int(json.load(f)["next_run"])

    def _path(self, i: int, name: str) -> str:
        return os.path.join(self.dir, f"{i:08x}", name)

    def is_quarantined(self, i: int) -> bool:
        return os.path.exists(self._path(i, INCOMPLETE_MARKER))

    def nr_stored_histories(self) -> int:
        """One past the last run that has a result."""
        n = 0
        for i in range(self._next_run):
            if os.path.exists(self._path(i, "result.json")):
                n = i + 1
        return n

    def run_tokens(self) -> List[Optional[RunToken]]:
        """A stat token for each run below ``next_run``, None for a run
        without a result; at most three stats a run. One past the last
        token that is not None is ``nr_stored_histories()``."""
        tokens: List[Optional[RunToken]] = []
        for i in range(self._next_run):
            run = os.path.join(self.dir, f"{i:08x}")
            result = _stat(os.path.join(run, "result.json"))
            tokens.append(None if result is None else (
                _stat(run), result, _stat(os.path.join(run, "trace.json"))))
        return tokens

    def _result(self, i: int) -> Dict[str, Any]:
        if self.is_quarantined(i):
            raise StorageError(f"run {i:08x} is quarantined (INCOMPLETE)")
        path = self._path(i, "result.json")
        if not os.path.exists(path):
            raise StorageError(f"run {i:08x} has no result")
        with open(path) as f:
            return json.load(f)

    def _trace(self, i: int) -> List[ActionRecord]:
        path = self._path(i, "trace.json")
        if not os.path.exists(path):
            raise StorageError(f"run {i:08x} has no trace")
        with open(path) as f:
            return [ActionRecord.from_jsonable(d) for d in json.load(f)]

    def get_stored_history(self, i: int) -> List[ActionRecord]:
        self._result(i)  # quarantined or result-less runs are invisible
        return self._trace(i)

    def read_run(self, i: int
                 ) -> Tuple[List[ActionRecord], bool, Dict[str, Any]]:
        """``(get_stored_history(i), is_successful(i), get_metadata(i))``
        from one parse of ``result.json``; raises where they raise."""
        result = self._result(i)
        trace = self._trace(i)
        return (trace, bool(result["successful"]),
                dict(result.get("metadata") or {}))

    def is_successful(self, i: int) -> bool:
        return bool(self._result(i)["successful"])

    def get_metadata(self, i: int) -> Dict[str, Any]:
        return dict(self._result(i).get("metadata") or {})


def load_storage(dir_path: str) -> NaiveHistory:
    """Open an existing storage directory for reading. Only the naive
    type is readable; another type raises, naming it."""
    meta_path = os.path.join(dir_path, "storage.json")
    if not os.path.exists(meta_path):
        raise StorageError(
            f"not a storage dir (no storage.json): {dir_path}")
    with open(meta_path) as f:
        kind = json.load(f).get("type")
    if kind != NaiveHistory.NAME:
        raise StorageError(
            f"storage type {kind!r} is not readable by namazu_tpu_torch "
            f"(only {NaiveHistory.NAME!r}): {dir_path}")
    return NaiveHistory(dir_path)
