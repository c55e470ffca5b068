"""Host-side trace featurization: event streams -> fixed-shape arrays.

The port's own copy of ``namazu_tpu/ops/trace_encoding.py`` (numpy only):
each trace is encoded as

* ``hint_ids``  int32[L] — replay hint hashed (fnv64a) into H buckets;
* ``entity_ids`` int32[L] — entity index (stable per stream);
* ``arrival``   float32[L] — arrival offset in seconds from run start;
* ``mask``      bool[L] — valid positions (traces are right-padded).

Precedence pairs are sampled over hint buckets, so every trace lands in
one feature space. Encoding from a recorded ``SingleTrace`` waits for the
ingest slice of the port.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

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
