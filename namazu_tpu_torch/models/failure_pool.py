"""Durable cross-run failure-signature pool: the port's own copy of
``namazu_tpu/models/failure_pool.py``.

Every ingested failure's realized encoding (the signature the search
chases), its arrival view and its demonstration seed table are written
to a shared directory, one ``<digest>.npz`` per distinct signature, so a
later ingest (the same storage, another batch, another process, either
package) folds the pooled signatures into its failure archive and seeds
before evolving. Entries are keyed by the content digest of the masked
trace: re-pooling a known signature is a no-op, and two writers racing
on one signature land on the same name by an atomic rename, so the pool
keeps exactly one entry. Entries stamp the hint space and bucket count;
an entry of another build or config is skipped, never trusted.

The ``.npz`` keys, the JSON wire form (``entry_to_jsonable``) and the
digest are the reference's, so a pool written by either package is read
by the other.
"""

from __future__ import annotations

import hashlib
import io
import logging
import os
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Set, Tuple

import numpy as np

from namazu_tpu_torch.ops.trace_encoding import HINT_SPACE, EncodedTrace
from namazu_tpu_torch.utils.atomic import TMP_SUFFIX, atomic_write

log = logging.getLogger("namazu_tpu_torch.failure_pool")

#: newest entries loaded per ingest: the failure archive's ring capacity
MAX_LOAD = 64


class PoolEntry(NamedTuple):
    digest: str
    realized: EncodedTrace  # release-time view (archive embedding)
    arrival: EncodedTrace  # arrival view (reference fallback)
    seed: Optional[np.ndarray]  # f32[H] demonstration table, or None


def trace_digest(enc: EncodedTrace) -> str:
    """Content digest of the masked trace: the hint/entity sequence,
    timing and padding excluded. Two runs that interleaved the same events
    in the same order are one failure signature."""
    m = enc.mask
    h = hashlib.sha256()
    h.update(enc.hint_ids[m].tobytes())
    h.update(enc.entity_ids[m].tobytes())
    return h.hexdigest()[:32]


def pool_add(pool_dir: str, realized: EncodedTrace, arrival: EncodedTrace,
             seed: Optional[np.ndarray], H: int) -> str:
    """Persist one failure signature; returns its digest. An existing
    entry with the same digest is left untouched."""
    return pool_put(pool_dir, realized, arrival, seed, H)[0]


def pool_put(pool_dir: str, realized: EncodedTrace, arrival: EncodedTrace,
             seed: Optional[np.ndarray], H: int) -> Tuple[str, bool]:
    """:func:`pool_add` that also says whether the entry was new (False:
    a content-keyed dedupe hit)."""
    digest = trace_digest(realized)
    os.makedirs(pool_dir, exist_ok=True)
    path = os.path.join(pool_dir, f"{digest}.npz")
    if os.path.exists(path):
        return digest, False
    payload = {
        "hint_space": np.asarray(HINT_SPACE),
        "H": np.asarray(H),
        "hint_ids": realized.hint_ids,
        "entity_ids": realized.entity_ids,
        "released": realized.arrival,  # the realized view's time vector
        "arrival": arrival.arrival,
        "mask": realized.mask,
        "faultable": realized.faultable,
    }
    if seed is not None:
        payload["seed"] = np.asarray(seed, np.float32)
    buf = io.BytesIO()
    np.savez(buf, **payload)
    atomic_write(path, buf.getvalue(), seams=False)  # as the reference's
    return digest, True


def pool_load(pool_dir: str, H: int,
              exclude: Optional[Set[str]] = None,
              max_entries: int = MAX_LOAD) -> List[PoolEntry]:
    """Up to ``max_entries`` pooled signatures of this build's hint space
    and bucket count, newest first, skipping the digests in ``exclude``.
    Entries of another space or H are skipped with one warning; the
    digest is recomputed from the content, never read off the name."""
    exclude = exclude or set()
    if not os.path.isdir(pool_dir):
        return []
    files = []
    for name in os.listdir(pool_dir):
        if not name.endswith(".npz") or name[:-4] in exclude:
            continue
        path = os.path.join(pool_dir, name)
        try:
            files.append((os.path.getmtime(path), path))
        except OSError:
            continue
    files.sort(reverse=True)  # newest first
    entries: List[PoolEntry] = []
    seen: Set[str] = set()
    incompatible = 0
    for _, path in files:
        if len(entries) >= max_entries:
            break
        try:
            with np.load(path) as z:
                if (str(z["hint_space"]) != HINT_SPACE
                        or int(z["H"]) != H):
                    incompatible += 1
                    continue
                ids, ents = z["hint_ids"], z["entity_ids"]
                mask, fb = z["mask"], z["faultable"]
                realized = EncodedTrace(ids, ents, z["released"], mask,
                                        faultable=fb)
                digest = trace_digest(realized)
                if digest in exclude or digest in seen:
                    continue
                seen.add(digest)
                entries.append(PoolEntry(
                    digest=digest,
                    realized=realized,
                    arrival=EncodedTrace(ids, ents, z["arrival"], mask,
                                         faultable=fb),
                    seed=np.array(z["seed"]) if "seed" in z else None,
                ))
        except Exception:
            log.exception("unreadable pool entry %s; skipping", path)
    if incompatible:
        log.warning("%d pooled signature(s) from another hint space or "
                    "bucket count were skipped (this build: %s, H=%d)",
                    incompatible, HINT_SPACE, H)
    return entries


def pool_size(pool_dir: str) -> int:
    """Number of stored signatures."""
    if not os.path.isdir(pool_dir):
        return 0
    return sum(1 for n in os.listdir(pool_dir) if n.endswith(".npz"))


# -- the wire form (knowledge service) ------------------------------------

def entry_to_jsonable(realized: EncodedTrace, arrival: EncodedTrace,
                      seed: Optional[np.ndarray], H: int) -> Dict[str, Any]:
    """One failure signature as the ``pool_push`` wire dict: only the
    masked prefix travels."""
    m = realized.mask
    d: Dict[str, Any] = {
        "hint_space": HINT_SPACE,
        "H": int(H),
        "hint_ids": realized.hint_ids[m].tolist(),
        "entity_ids": realized.entity_ids[m].tolist(),
        "released": realized.arrival[m].tolist(),
        "arrival": arrival.arrival[m].tolist(),
        "faultable": realized.faultable[m].tolist(),
    }
    if seed is not None:
        d["seed"] = np.asarray(seed, np.float32).tolist()
    return d


def entry_from_jsonable(d: Dict[str, Any]) -> Tuple[EncodedTrace,
                                                    EncodedTrace,
                                                    Optional[np.ndarray],
                                                    int]:
    """Inverse of :func:`entry_to_jsonable`: ``(realized, arrival, seed,
    H)``. Raises on a payload of another hint space or with arrays of
    unequal length (the caller skips the entry)."""
    if d.get("hint_space") != HINT_SPACE:
        raise ValueError(f"entry from hint space {d.get('hint_space')!r} "
                         f"(this build: {HINT_SPACE!r})")
    hint_ids = np.asarray(d["hint_ids"], np.int32)
    n = len(hint_ids)
    entity_ids = np.asarray(d["entity_ids"], np.int32)
    released = np.asarray(d["released"], np.float32)
    arrival_t = np.asarray(d["arrival"], np.float32)
    faultable = np.asarray(d.get("faultable", np.ones(n)), bool)
    if not (len(entity_ids) == len(released) == len(arrival_t)
            == len(faultable) == n):
        raise ValueError("entry arrays disagree on length")
    mask = np.ones((n,), bool)
    realized = EncodedTrace(hint_ids, entity_ids, released, mask,
                            faultable=faultable)
    arrival = EncodedTrace(hint_ids, entity_ids, arrival_t, mask,
                           faultable=faultable)
    seed = (np.asarray(d["seed"], np.float32)
            if d.get("seed") is not None else None)
    return realized, arrival, seed, int(d["H"])


def entries_to_pool_entries(dicts: Sequence[Dict[str, Any]], H: int
                            ) -> List[PoolEntry]:
    """Pulled wire entries as :class:`PoolEntry` objects, skipping (with
    one warning) anything malformed or of another hint space or H."""
    out: List[PoolEntry] = []
    skipped = 0
    for d in dicts:
        try:
            realized, arrival, seed, entry_h = entry_from_jsonable(d)
            if entry_h != H:
                skipped += 1
                continue
            out.append(PoolEntry(digest=trace_digest(realized),
                                 realized=realized, arrival=arrival,
                                 seed=seed))
        except Exception:
            skipped += 1
    if skipped:
        log.warning("%d pulled knowledge entr(ies) were malformed or from "
                    "another hint space/bucket count; skipped", skipped)
    return out


# -- integrity -------------------------------------------------------------

def pool_fsck(pool_dir: str, repair: bool = False) -> Dict[str, Any]:
    """Integrity report over a pool directory: stray atomic-write temps
    (``repair`` deletes them) and unreadable ``.npz`` entries (``repair``
    renames them to ``.bad`` so loaders stop re-parsing them)."""
    report: Dict[str, Any] = {
        "pool_dir": os.path.abspath(pool_dir),
        "entries": 0,
        "tmp_artifacts": [],
        "unreadable_entries": [],
        "repaired": [],
    }
    if not os.path.isdir(pool_dir):
        return report
    for name in sorted(os.listdir(pool_dir)):
        path = os.path.join(pool_dir, name)
        if name.endswith(TMP_SUFFIX):
            report["tmp_artifacts"].append(name)
            if repair:
                try:
                    os.unlink(path)
                    report["repaired"].append(name)
                except OSError:
                    pass
            continue
        if not name.endswith(".npz"):
            continue
        try:
            with np.load(path) as z:
                _ = z["hint_ids"]  # force a header and member read
            report["entries"] += 1
        except Exception:
            report["unreadable_entries"].append(name)
            if repair:
                try:
                    os.replace(path, path + ".bad")
                    report["repaired"].append(name)
                except OSError:
                    pass
    return report
