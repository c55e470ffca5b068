"""Host-side trace featurization: recorded runs and event streams ->
fixed-shape arrays.

The port's own copy of ``namazu_tpu/ops/trace_encoding.py`` (numpy only):
each trace is encoded as

* ``hint_ids``  int32[L] — replay hint hashed (fnv64a) into H buckets;
* ``entity_ids`` int32[L] — entity index (stable per stream);
* ``arrival``   float32[L] — arrival offset in seconds from run start;
* ``mask``      bool[L] — valid positions (traces are right-padded);
* ``faultable`` bool[L] — the cause event's class can carry a fault.

Precedence pairs are sampled over hint buckets, so every trace lands in
one feature space. A recorded run is a sequence of action records
(``namazu_tpu_torch/history.py``): anything with ``class_name``,
``entity_id``, ``event_class``, ``event_hint``, ``event_arrived`` and
``triggered_time`` attributes.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

DEFAULT_L = 256  # default length quantum for encoded traces
DEFAULT_H = 256  # hint buckets (genome length)
DEFAULT_K = 256  # precedence pairs (feature dimension)

# encoded lengths are rounded up to a multiple of this, so the scorer sees
# a handful of shapes instead of one per run length
L_QUANTUM = 128

# version tag of the replay-hint format whose hashes build the bucket
# space; checkpoints from another space are refused at load
HINT_SPACE = "flow-v2"

FNV64_OFFSET = 0xCBF29CE484222325
FNV64_PRIME = 0x100000001B3


def fnv64a(data: bytes) -> int:
    h = FNV64_OFFSET
    for b in data:
        h ^= b
        h = (h * FNV64_PRIME) & 0xFFFFFFFFFFFFFFFF
    return h


def checkpoint_hint_space(z) -> str:
    """Hint-space tag of a checkpoint npz mapping; checkpoints without the
    tag were built from bare content hints ("content-v1")."""
    return str(z["hint_space"]) if "hint_space" in z else "content-v1"


def _auto_length(n: int) -> int:
    """Padded length for an n-event trace: next multiple of L_QUANTUM, at
    least one quantum. No truncation."""
    return max(L_QUANTUM, -(-n // L_QUANTUM) * L_QUANTUM)


def hint_bucket(hint: str, n_buckets: int = DEFAULT_H) -> int:
    return fnv64a(hint.encode()) % n_buckets


def fault_coin(seed: int, H: int = DEFAULT_H) -> np.ndarray:
    """Deterministic per-bucket fault coin ``f32[H]`` in [0, 1).

    The ``tpu_search`` policy drops an event iff ``coin[bucket] <
    faults[bucket]``, with this same coin, and the scorer removes exactly
    those events (``ops/schedule.py`` ``drop_mask``): a searched fault
    table replays to the drops it was scored with."""
    return np.array(
        [fnv64a(f"{seed}|fault|{h}".encode()) % 10_000 / 10_000.0
         for h in range(H)],
        np.float32,
    )


# Signal classes registered by namazu_tpu/signal/{event,action}.py, split
# by whether the class overrides Event.default_fault_action (a packet
# drop, an EIO): a static copy, held to the reference's registry by
# tests/test_torch_ingest.py. Actions are not events and carry no fault.
FAULTABLE_CLASSES = frozenset({"PacketEvent", "FilesystemEvent"})
UNFAULTABLE_CLASSES = frozenset({
    "NopEvent", "ProcSetEvent", "FunctionEvent", "LogEvent",
    "NopAction", "EventAcceptanceAction", "PacketFaultAction",
    "FilesystemFaultAction", "ProcSetSchedAction", "ShellAction",
})


def class_supports_fault(class_name: str) -> bool:
    """Whether events of this signal class carry a fault action, i.e.
    whether the control plane can realize a drop for them. Unknown or
    unrecorded classes count as faultable, as in the reference."""
    return class_name not in UNFAULTABLE_CLASSES


class EncodedTrace:
    """One trace in array form (numpy; moved to the device by the search)."""

    def __init__(self, hint_ids, entity_ids, arrival, mask, truncated=0,
                 faultable=None):
        self.hint_ids = np.asarray(hint_ids, np.int32)
        self.entity_ids = np.asarray(entity_ids, np.int32)
        self.arrival = np.asarray(arrival, np.float32)
        self.mask = np.asarray(mask, bool)
        self.truncated = int(truncated)  # events beyond an explicit L cap
        self.faultable = (np.ones_like(self.mask) if faultable is None
                          else np.asarray(faultable, bool))

    @property
    def length(self) -> int:
        return int(self.mask.sum())


def action_hint(action) -> str:
    """An action's semantic identity: its cause event's replay hint, or
    cause class + entity for actions recorded without one."""
    return action.event_hint or \
        f"{action.event_class or action.class_name}:{action.entity_id}"


def encode_trace(trace, L: Optional[int] = None, H: int = DEFAULT_H,
                 entity_index: Optional[Dict[str, int]] = None,
                 realized: bool = False) -> EncodedTrace:
    """Encode a recorded run: the arrival view, or with ``realized`` the
    release view (see :func:`encode_trace_views`)."""
    views = encode_trace_views(trace, L=L, H=H, entity_index=entity_index)
    return views[1] if realized else views[0]


def encode_trace_views(
    trace,
    L: Optional[int] = None,
    H: int = DEFAULT_H,
    entity_index: Optional[Dict[str, int]] = None,
) -> Tuple[EncodedTrace, EncodedTrace]:
    """Both time views of one recorded run, ``(arrival_view,
    realized_view)``, sharing the identity arrays.

    The arrival view stamps each event at its cause event's arrival
    (``event_arrived``), the counterfactual anchor of the search; the
    realized view at its release (``triggered_time``), where an injected
    interleaving's signature lives. Each view falls back to the other's
    time where one was not recorded, and to index spacing (1 ms) where
    neither was. Times are offsets from the earliest recorded time of the
    view (``a0``/``r0``). ``L=None`` sizes to the whole run; an explicit
    ``L`` truncates (``truncated`` says how many events were dropped)."""
    entity_index = entity_index if entity_index is not None else {}
    actions = list(trace)
    if L is None:
        L = _auto_length(len(actions))
    hint_ids = np.zeros(L, np.int32)
    entity_ids = np.zeros(L, np.int32)
    arrival = np.zeros(L, np.float32)
    released = np.zeros(L, np.float32)
    mask = np.zeros(L, bool)
    faultable = np.ones(L, bool)

    arr_times: List[float] = []
    rel_times: List[float] = []
    for a in actions:
        arrived = a.event_arrived or 0.0
        rel = a.triggered_time or 0.0
        arr_times.append(arrived if arrived else rel)
        rel_times.append(rel if rel else arrived)
    a0 = min((t for t in arr_times if t), default=0.0)
    r0 = min((t for t in rel_times if t), default=0.0)

    for i, action in enumerate(actions[:L]):
        ent = action.entity_id
        if ent not in entity_index:
            entity_index[ent] = len(entity_index)
        hint_ids[i] = hint_bucket(action_hint(action), H)
        entity_ids[i] = entity_index[ent]
        arrival[i] = (arr_times[i] - a0) if arr_times[i] else i * 1e-3
        released[i] = (rel_times[i] - r0) if rel_times[i] else i * 1e-3
        mask[i] = True
        faultable[i] = class_supports_fault(action.event_class)
    truncated = max(0, len(actions) - L)
    return (
        EncodedTrace(hint_ids, entity_ids, arrival, mask,
                     truncated=truncated, faultable=faultable),
        EncodedTrace(hint_ids, entity_ids, released, mask,
                     truncated=truncated, faultable=faultable),
    )


def encode_event_stream(
    hints: Sequence[str],
    arrivals: Optional[Sequence[float]] = None,
    entities: Optional[Sequence[str]] = None,
    L: Optional[int] = None,
    H: int = DEFAULT_H,
) -> EncodedTrace:
    """Encode an event stream from raw replay hints. ``L=None`` sizes to
    the whole stream."""
    if L is None:
        L = _auto_length(len(hints))
    n = min(len(hints), L)
    hint_ids = np.zeros(L, np.int32)
    entity_ids = np.zeros(L, np.int32)
    arrival = np.zeros(L, np.float32)
    mask = np.zeros(L, bool)
    ent_index: Dict[str, int] = {}
    for i in range(n):
        hint_ids[i] = hint_bucket(hints[i], H)
        if entities is not None:
            e = entities[i]
            if e not in ent_index:
                ent_index[e] = len(ent_index)
            entity_ids[i] = ent_index[e]
        arrival[i] = arrivals[i] if arrivals is not None else i * 1e-3
        mask[i] = True
    return EncodedTrace(hint_ids, entity_ids, arrival, mask,
                        truncated=max(0, len(hints) - L))


def sample_pairs(
    K: int = DEFAULT_K, H: int = DEFAULT_H, seed: int = 0
) -> np.ndarray:
    """Deterministically sample K ordered hint-bucket pairs (u != v)."""
    rng = np.random.RandomState(seed)
    u = rng.randint(0, H, size=K).astype(np.int32)
    v = rng.randint(0, H - 1, size=K).astype(np.int32)
    v = np.where(v >= u, v + 1, v).astype(np.int32)  # ensure u != v
    return np.stack([u, v], axis=1)  # [K, 2]


def informative_pairs(
    occupied: Sequence[int],
    K: int = DEFAULT_K,
    H: int = DEFAULT_H,
    seed: int = 0,
) -> np.ndarray:
    """K ordered hint-bucket pairs concentrated on the buckets that occur
    in the recorded traces: every ordered pair of occupied buckets first
    (a seeded sample of K of them when there are more), the rest filled
    with uniform pairs so unseen buckets still project somewhere."""
    occ = sorted({int(b) for b in occupied})
    pairs = [(u, v) for u in occ for v in occ if u != v]
    rng = np.random.RandomState(seed)
    if len(pairs) >= K:
        idx = rng.choice(len(pairs), size=K, replace=False)
        return np.array([pairs[i] for i in sorted(idx)], np.int32)
    fill = sample_pairs(K - len(pairs), H, seed)
    if not pairs:
        return fill
    return np.concatenate([np.array(pairs, np.int32), fill])


def envelope_trace(encs: Sequence[EncodedTrace]) -> EncodedTrace:
    """Per-bucket minimum-arrival envelope of several encoded traces: one
    event per observed bucket at its earliest arrival over the inputs,
    sorted by time. Features depend only on each bucket's first
    occurrence, so this is the tightest lower envelope of those runs."""
    firsts: Dict[int, float] = {}
    ents: Dict[int, int] = {}
    flts: Dict[int, bool] = {}
    for e in encs:
        m = e.mask
        for b, t, en, fb in zip(e.hint_ids[m], e.arrival[m],
                                e.entity_ids[m], e.faultable[m]):
            b = int(b)
            if b not in firsts or t < firsts[b]:
                firsts[b] = float(t)
                ents[b] = int(en)
                flts[b] = bool(fb)
    items = sorted(firsts.items(), key=lambda kv: kv[1])
    L = _auto_length(len(items))
    hint_ids = np.zeros(L, np.int32)
    entity_ids = np.zeros(L, np.int32)
    arrival = np.zeros(L, np.float32)
    mask = np.zeros(L, bool)
    faultable = np.ones(L, bool)
    for i, (b, t) in enumerate(items):
        hint_ids[i] = b
        entity_ids[i] = ents[b]
        arrival[i] = t
        mask[i] = True
        faultable[i] = flts[b]
    return EncodedTrace(hint_ids, entity_ids, arrival, mask,
                        faultable=faultable)


def pad_trace_row(enc: EncodedTrace, L: int) -> Dict[str, np.ndarray]:
    """One trace's scoring arrays right-padded to ``L``: 0 for ids/times,
    False for the mask/faultable flags. Shared by :func:`stack_traces` and
    the search's device-resident trace rows, so both pad alike."""
    def pad(a, fill):
        n = L - a.shape[0]
        if n <= 0:
            return a
        return np.concatenate([a, np.full((n,), fill, a.dtype)])

    return {
        "hint": pad(enc.hint_ids, 0),
        "ent": pad(enc.entity_ids, 0),
        "arr": pad(enc.arrival, 0),
        "mask": pad(enc.mask, False),
        "flt": pad(enc.faultable, False),
    }


def stack_traces(traces: Sequence[EncodedTrace]) -> Tuple[np.ndarray, ...]:
    """Stack encoded traces into ``[T, L]`` arrays ``(hint_ids,
    entity_ids, arrival, mask, faultable)``, right-padding to the longest."""
    L = max(t.hint_ids.shape[0] for t in traces)
    rows = [pad_trace_row(t, L) for t in traces]
    return (
        np.stack([r["hint"] for r in rows]),
        np.stack([r["ent"] for r in rows]),
        np.stack([r["arr"] for r in rows]),
        np.stack([r["mask"] for r in rows]),
        np.stack([r["flt"] for r in rows]),
    )
