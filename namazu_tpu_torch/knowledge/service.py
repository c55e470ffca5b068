"""The multi-tenant knowledge service the sidecar hosts: the port's
counterpart of ``namazu_tpu/knowledge/service.py``.

One instance serves every campaign of a host: a content-keyed failure
pool on disk, per-scenario best delay tables, the pooled relation
coverage of each (scenario, bitmap space), one triage dossier per
failure signature, per-tenant counts, and shared reward surrogates
trained across tenants. State is written crash-safe (``utils/atomic.py``;
pool entries through ``failure_pool.pool_put``), so a restarted service
resumes with the same knowledge, and a re-push after the restart dedupes.

Surrogate features are precedence-pair embeddings whose pairs depend on
a tenant's occupied buckets, so examples pool only between searches of
one pair sample and width: the stores are keyed by ``(scenario,
pairs_fp, K)`` and persisted as ``<state>/surrogate_<id>.npz``. A store's
model is the port's ``RewardSurrogate`` on the service's device; it
trains and persists outside the service lock, serialized per store.

Every file the service writes has the reference's format, so a pool
directory and its ``_state`` move between the two packages' services:
pool entries, ``scenarios.json``, ``coverage.json``, ``triage.json`` and
the example stores.
"""

from __future__ import annotations

import hashlib
import io
import json
import logging
import os
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, Optional, Tuple

import numpy as np

from namazu_tpu_torch.device import DeviceLike, resolve_device
from namazu_tpu_torch.knowledge.client import WIRE_VERSION
from namazu_tpu_torch.models.failure_pool import (
    MAX_LOAD,
    entry_from_jsonable,
    entry_to_jsonable,
    pool_load,
    pool_put,
    pool_size,
)
from namazu_tpu_torch.models.surrogate import RewardSurrogate
from namazu_tpu_torch.utils.atomic import atomic_write, atomic_write_json

log = logging.getLogger("namazu_tpu_torch.knowledge.service")

#: labeled examples kept per surrogate store (digest-keyed LRU)
MAX_EXAMPLES = 2048

#: labeled examples needed in each class before a store trains and serves
MIN_CLASS_EXAMPLES = 3


def new_surrogate(K: int, device) -> RewardSurrogate:
    """A store's fresh model: the port's surrogate, seed 0 as in the
    reference."""
    return RewardSurrogate(K=K, seed=0, device=device)


class _SurrogateStore:
    """One (scenario, feature space)'s labeled examples and model.

    Examples change under the service lock; the fit and the persist run
    outside it on a snapshot, serialized by ``train_lock``."""

    def __init__(self, K: int):
        self.K = K
        # digest -> (feats f32[K], label), in LRU order
        self.examples: "OrderedDict[str, Tuple[np.ndarray, float]]" = \
            OrderedDict()
        self.model: Optional[RewardSurrogate] = None
        self.train_rounds = 0
        self.dirty = False  # examples added since the last fit
        self.train_lock = threading.Lock()

    def add(self, digest: str, feats: np.ndarray, label: float) -> None:
        if digest in self.examples:
            del self.examples[digest]  # refresh its place and label
        self.examples[digest] = (feats, label)
        while len(self.examples) > MAX_EXAMPLES:
            self.examples.popitem(last=False)
        self.dirty = True

    def dataset(self) -> Tuple[np.ndarray, np.ndarray]:
        feats = (np.stack([f for f, _ in self.examples.values()])
                 if self.examples else np.zeros((0, self.K), np.float32))
        labels = np.asarray([lb for _, lb in self.examples.values()],
                            np.float32)
        return feats, labels

    def trainable(self) -> bool:
        labels = np.asarray([lb for _, lb in self.examples.values()])
        pos = int((labels > 0.5).sum())
        return min(pos, len(labels) - pos) >= MIN_CLASS_EXAMPLES

    def train_on(self, feats: np.ndarray, labels: np.ndarray,
                 device) -> None:
        """One fit round (2 epochs, seeded by the round) on a snapshot,
        outside the service lock. A device error raises."""
        with self.train_lock:
            if self.model is None:
                self.model = new_surrogate(self.K, device)
            self.model.train(feats, labels, epochs=2,
                             seed=self.train_rounds)
            self.train_rounds += 1


class KnowledgeService:
    """Handler of the knowledge wire ops, hosted by the sidecar. Each
    connection is served on its own thread; one lock guards the in-memory
    state, and no op holds it across disk scans, fits or inference."""

    VERSION = WIRE_VERSION
    OPS = ("pool_push", "pool_pull", "surrogate_predict", "stats",
           "triage_push", "triage_pull")

    def __init__(self, pool_dir: str, state_dir: str = "",
                 device: DeviceLike = "cuda"):
        if not pool_dir:
            raise ValueError("KnowledgeService needs a pool directory")
        self.device = resolve_device(device)
        self.pool_dir = os.path.abspath(pool_dir)
        # a subdirectory by default: state .npz files must never pass for
        # pool entries
        self.state_dir = os.path.abspath(
            state_dir or os.path.join(self.pool_dir, "_state"))
        os.makedirs(self.pool_dir, exist_ok=True)
        os.makedirs(self.state_dir, exist_ok=True)
        self._lock = threading.Lock()
        # tenant -> {"first_seen", "last_seen", "pushes", "pulls"}
        self._tenants: Dict[str, Dict[str, Any]] = {}
        # scenario -> {"delays", "fitness", "H", "updated_at"}
        self._scenarios: Dict[str, Dict[str, Any]] = {}
        # "scenario@HxWxWIN" -> {"scenario", "H", "w", "win", "bits"}
        self._coverage: Dict[str, Dict[str, Any]] = {}
        self._surrogates: Dict[Tuple[str, str, int], _SurrogateStore] = {}
        # failure signature -> dossier
        self._triage: Dict[str, Dict[str, Any]] = {}
        self._pushes = 0
        self._pulls = 0
        self._dedupe_hits = 0
        self._triage_pulls = 0
        self._triage_hits = 0
        self._load_state()

    def close(self) -> None:
        """Nothing to release: every write is already on disk."""

    # -- persistence ------------------------------------------------------

    def _scenario_path(self) -> str:
        return os.path.join(self.state_dir, "scenarios.json")

    def _coverage_path(self) -> str:
        return os.path.join(self.state_dir, "coverage.json")

    def _triage_path(self) -> str:
        return os.path.join(self.state_dir, "triage.json")

    def _store_path(self, key: Tuple[str, str, int]) -> str:
        sid = hashlib.sha256(
            f"{key[0]}|{key[1]}|{key[2]}".encode()).hexdigest()[:16]
        return os.path.join(self.state_dir, f"surrogate_{sid}.npz")

    def _load_state(self) -> None:
        def read(path, what):
            try:
                with open(path) as f:
                    return json.load(f)
            except FileNotFoundError:
                return None
            except Exception:
                log.exception("%s state unreadable; starting empty", what)
                return None

        scenarios = read(self._scenario_path(), "scenario table")
        if isinstance(scenarios, dict):
            self._scenarios = scenarios
        coverage = read(self._coverage_path(), "coverage")
        if isinstance(coverage, dict):
            try:
                self._coverage = {
                    key: {"scenario": str(c.get("scenario", key)),
                          "H": int(c["H"]), "w": int(c["w"]),
                          "win": int(c.get("win", 0)),
                          "bits": {int(b) for b in c.get("bits", [])}}
                    for key, c in coverage.items()}
            except Exception:
                log.exception("coverage state malformed; starting empty")
        triage = read(self._triage_path(), "triage dossier")
        if isinstance(triage, dict):
            self._triage = {str(sig): dict(d) for sig, d in triage.items()
                            if isinstance(d, dict)}

    def _save_json(self, path: str, obj, what: str) -> None:
        try:
            atomic_write_json(path, obj, sort_keys=True)
        except OSError:
            log.exception("could not persist %s", what)

    def _save_coverage(self) -> None:
        self._save_json(
            self._coverage_path(),
            {key: {"scenario": c["scenario"], "H": c["H"], "w": c["w"],
                   "win": c["win"], "bits": sorted(c["bits"])}
             for key, c in self._coverage.items()}, "pooled coverage")

    @staticmethod
    def _coverage_key(scenario: str, h: int, w: int, win: int) -> str:
        return f"{scenario}@{h}x{w}x{win}"

    def _save_store(self, key: Tuple[str, str, int], digests, feats,
                    labels) -> None:
        buf = io.BytesIO()
        np.savez(buf, feats=feats, labels=labels,
                 digests=np.asarray(digests),
                 scenario=np.asarray(key[0]), pairs_fp=np.asarray(key[1]))
        try:
            atomic_write(self._store_path(key), buf.getvalue())
        except OSError:
            log.exception("could not persist surrogate examples")

    def _get_store(self, key: Tuple[str, str, int]) -> _SurrogateStore:
        store = self._surrogates.get(key)
        if store is not None:
            return store
        store = _SurrogateStore(K=key[2])
        try:
            with np.load(self._store_path(key)) as z:
                for d, f, lb in zip(z["digests"], z["feats"], z["labels"]):
                    store.add(str(d), np.asarray(f, np.float32), float(lb))
            store.dirty = True  # retrain lazily from the recovered set
        except FileNotFoundError:
            pass
        except Exception:
            log.exception("surrogate example state unreadable; starting "
                          "empty")
        self._surrogates[key] = store
        return store

    # -- dispatch ---------------------------------------------------------

    def handle(self, req: dict) -> dict:
        op = str(req.get("op"))
        handler = {
            "pool_push": self._pool_push,
            "pool_pull": self._pool_pull,
            "surrogate_predict": self._surrogate_predict,
            "stats": self._stats,
            "triage_push": self._triage_push,
            "triage_pull": self._triage_pull,
        }.get(op)
        if handler is None:
            return {"ok": False, "v": self.VERSION,
                    "error": f"unknown knowledge op {op!r}"}
        try:
            resp = handler(req)
        except (KeyError, TypeError, ValueError) as e:
            # a malformed request costs that request
            log.exception("knowledge op %s failed", op)
            resp = {"ok": False, "error": repr(e)}
        # persists and fits snapped under the lock run here, outside it;
        # a device error in a fit raises to the wire (answered ok: false)
        deferred = resp.pop("_deferred", ())
        trained = False
        for key, store, digests, feats, labels, want_train in deferred:
            self._save_store(key, digests, feats, labels)
            if want_train:
                store.train_on(feats, labels, self.device)
                trained = True
        if deferred and op == "pool_push":
            resp["trained"] = trained
        resp.setdefault("v", self.VERSION)
        return resp

    def _touch_tenant(self, req: dict, what: str) -> str:
        tenant = str(req.get("tenant") or "anon")
        now = time.time()
        t = self._tenants.setdefault(
            tenant, {"first_seen": now, "pushes": 0, "pulls": 0})
        t["last_seen"] = now
        t[what] = t.get(what, 0) + 1
        return tenant

    # -- ops --------------------------------------------------------------

    def _pool_push(self, req: dict) -> dict:
        """Failure signatures (content-keyed, exactly once; written
        outside the lock), and optionally a scenario's best table, its
        coverage bits and labeled surrogate examples, in one round trip."""
        scenario = str(req.get("scenario") or "")
        accepted = duplicates = rejected = 0
        for d in req.get("entries") or []:
            try:
                realized, arrival, seed, entry_h = entry_from_jsonable(d)
                _, added = pool_put(self.pool_dir, realized, arrival, seed,
                                    entry_h)
            except Exception:
                rejected += 1
                continue
            if added:
                accepted += 1
            else:
                duplicates += 1
        best = req.get("best")
        coverage = req.get("coverage")
        examples = req.get("examples") or []
        pairs_fp = str(req.get("pairs_fp") or "")
        with self._lock:
            self._touch_tenant(req, "pushes")
            self._pushes += 1
            self._dedupe_hits += duplicates
            if best and scenario:
                self._install_best(scenario, best)
            if coverage and scenario:
                self._merge_coverage(scenario, coverage)
            deferred = []
            if examples and scenario and pairs_fp:
                deferred = self._add_examples(scenario, pairs_fp, examples)
        return {"ok": True, "accepted": accepted, "duplicates": duplicates,
                "rejected": rejected, "trained": False,
                "_deferred": deferred, "pool_size": pool_size(self.pool_dir)}

    def _install_best(self, scenario: str, best: dict) -> None:
        """Keep the highest-fitness delay table per scenario."""
        try:
            delays = [float(x) for x in best["delays"]]
            fitness = float(best["fitness"])
            h = int(best.get("H") or len(delays))
        except (KeyError, TypeError, ValueError):
            return
        if not np.isfinite(fitness) or len(delays) != h:
            return
        cur = self._scenarios.get(scenario)
        if cur is not None and cur.get("H") == h \
                and cur.get("fitness", float("-inf")) >= fitness:
            return
        self._scenarios[scenario] = {"delays": delays, "fitness": fitness,
                                     "H": h, "updated_at": time.time()}
        self._save_json(self._scenario_path(), self._scenarios,
                        "scenario tables")

    def _merge_coverage(self, scenario: str, coverage: dict) -> None:
        """Union a campaign's coverage bits into its (scenario, space)
        store; a malformed push costs that push, and each (H, width,
        window) space keeps its own store."""
        try:
            h = int(coverage["H"])
            w = int(coverage["w"])
            win = int(coverage.get("win", 0))
            bits = {int(b) for b in coverage.get("bits", [])}
        except (KeyError, TypeError, ValueError):
            return
        if w <= 0 or any(b < 0 or b >= w for b in bits):
            return
        key = self._coverage_key(scenario, h, w, win)
        cur = self._coverage.get(key)
        if cur is not None:
            if bits <= cur["bits"]:
                return  # nothing new: no persist
            cur["bits"] |= bits
        else:
            self._coverage[key] = {"scenario": scenario, "H": h, "w": w,
                                   "win": win, "bits": bits}
        self._save_coverage()

    def _add_examples(self, scenario: str, pairs_fp: str,
                      examples: list) -> list:
        """Fold examples into their stores (under the lock); returns the
        persist/fit snapshots for :meth:`handle` to run outside it."""
        touched = set()
        for ex in examples:
            try:
                feats = np.asarray(ex["feats"], np.float32)
                label = float(ex["label"])
                digest = str(ex.get("digest") or "")
            except (KeyError, TypeError, ValueError):
                continue
            if feats.ndim != 1 or not digest:
                continue
            key = (scenario, pairs_fp, int(feats.shape[0]))
            self._get_store(key).add(digest, feats, label)
            touched.add(key)
        return [self._snapshot_deferred(key, self._surrogates[key])
                for key in touched]

    @staticmethod
    def _snapshot_deferred(key: Tuple[str, str, int],
                           store: _SurrogateStore) -> Tuple:
        """An immutable persist (and maybe fit) work item; ``dirty``
        clears only when a fit will run, so thin example sets keep
        accumulating toward one."""
        digests = list(store.examples.keys())
        feats, labels = store.dataset()
        want_train = store.dirty and store.trainable()
        if want_train:
            store.dirty = False
        return key, store, digests, feats, labels, want_train

    def _pool_pull(self, req: dict) -> dict:
        """The warm-start: pooled signatures of the tenant's H (minus
        ``exclude``), the scenario's best table and, with
        ``coverage_space``, the coverage bits of exactly that space. The
        pool scan runs outside the lock."""
        h = int(req.get("H") or 0)
        scenario = str(req.get("scenario") or "")
        with self._lock:
            self._touch_tenant(req, "pulls")
            self._pulls += 1
            table: Optional[dict] = None
            cur = self._scenarios.get(scenario)
            if cur is not None and (h <= 0 or cur.get("H") == h):
                table = {"delays": cur["delays"], "fitness": cur["fitness"],
                         "H": cur["H"]}
            coverage: Optional[dict] = None
            space = req.get("coverage_space")
            if isinstance(space, dict):
                try:
                    cov = self._coverage.get(self._coverage_key(
                        scenario, int(space.get("H", 0)),
                        int(space.get("w", 0)), int(space.get("win", 0))))
                except (TypeError, ValueError):
                    cov = None
                if cov is not None:
                    coverage = {"H": cov["H"], "w": cov["w"],
                                "win": cov["win"],
                                "bits": sorted(cov["bits"])}
        exclude = set(req.get("exclude") or [])
        max_entries = int(req.get("max_entries", MAX_LOAD))
        entries = []
        if h > 0 and max_entries > 0:
            for e in pool_load(self.pool_dir, h, exclude=exclude,
                               max_entries=max_entries):
                try:
                    d = entry_to_jsonable(e.realized, e.arrival, e.seed, h)
                except Exception:
                    log.exception("pool entry %s unserializable; skipped",
                                  e.digest)
                    continue
                d["digest"] = e.digest
                entries.append(d)
        resp = {"ok": True, "entries": entries, "scenario_table": table,
                "pool_size": pool_size(self.pool_dir)}
        if coverage is not None:
            resp["coverage"] = coverage
        return resp

    def _surrogate_predict(self, req: dict) -> dict:
        """P(reproduce) per candidate feature row from the shared model of
        this (scenario, pairs_fp, width); ``trained: false`` when that
        space is unknown or still too thin. Inference runs outside the
        service lock, under the store's fit lock."""
        scenario = str(req.get("scenario") or "")
        pairs_fp = str(req.get("pairs_fp") or "")
        feats = np.asarray(req.get("feats") or [], np.float32)
        if feats.ndim != 2 or feats.shape[0] == 0:
            return {"ok": False, "error": "feats must be [N, K]"}
        key = (scenario, pairs_fp, int(feats.shape[1]))
        with self._lock:
            store = self._surrogates.get(key)
            if store is None and os.path.exists(self._store_path(key)):
                store = self._get_store(key)  # recovered after a restart
            if store is None:
                return {"ok": True, "trained": False}
            deferred = []
            if store.dirty:
                # a recovered or grown example set refits after this
                # reply, which still answers from the current model
                deferred.append(self._snapshot_deferred(key, store))
            model = store.model
        if model is None:
            return {"ok": True, "trained": False, "_deferred": deferred}
        with store.train_lock:
            probs = model.predict(feats)
        return {"ok": True, "trained": True,
                "probs": [float(p) for p in probs],
                "train_rounds": store.train_rounds, "_deferred": deferred}

    def _triage_push(self, req: dict) -> dict:
        """Attach a minimized-reproducer dossier to its signature; a
        stored dossier is replaced only by a better one (validated first,
        then fewer minimal flips)."""
        dossier = req.get("dossier")
        if not isinstance(dossier, dict):
            return {"ok": False, "error": "triage_push needs a dossier"}
        sig = str(dossier.get("signature") or "")
        if not sig:
            return {"ok": False, "error": "dossier has no failure signature"}
        dossier = dict(dossier, signature=sig)

        def rank(d: dict) -> Tuple[int, float]:
            try:
                flips = float(d.get("minimal_flips"))
            except (TypeError, ValueError):
                flips = float("inf")
            return (0 if d.get("validated") else 1, flips)

        with self._lock:
            self._touch_tenant(req, "pushes")
            cur = self._triage.get(sig)
            accepted = cur is None or rank(dossier) < rank(cur)
            if accepted:
                self._triage[sig] = dossier
                self._save_json(self._triage_path(), self._triage,
                                "triage dossiers")
            return {"ok": True, "accepted": accepted,
                    "dossier_count": len(self._triage)}

    def _triage_pull(self, req: dict) -> dict:
        sig = str(req.get("signature") or "")
        with self._lock:
            self._touch_tenant(req, "pulls")
            self._triage_pulls += 1
            dossier = self._triage.get(sig)
            if dossier is not None:
                self._triage_hits += 1
            return {"ok": True, "dossier": dossier,
                    "dossier_count": len(self._triage)}

    def _stats(self, req: dict) -> dict:
        """Pool, tenant, scenario, coverage, triage and surrogate
        occupancy."""
        with self._lock:
            return {
                "ok": True,
                "pool_dir": self.pool_dir,
                "pool_size": pool_size(self.pool_dir),
                "tenant_count": len(self._tenants),
                "tenants": {k: dict(v) for k, v in self._tenants.items()},
                "scenario_count": len(self._scenarios),
                "scenarios": {
                    fp: {"fitness": s["fitness"], "H": s["H"],
                         "updated_at": s["updated_at"]}
                    for fp, s in self._scenarios.items()},
                "pushes": self._pushes,
                "pulls": self._pulls,
                "dedupe_hits": self._dedupe_hits,
                "triage": {
                    "dossiers": len(self._triage),
                    "pulls": self._triage_pulls,
                    "hits": self._triage_hits,
                    "signatures": sorted(self._triage),
                },
                "coverage": {
                    key: {"scenario": c["scenario"], "H": c["H"],
                          "w": c["w"], "covered_bits": len(c["bits"]),
                          "occupancy": round(len(c["bits"]) / c["w"], 4)
                          if c["w"] else 0.0}
                    for key, c in self._coverage.items()},
                "surrogate": {
                    "stores": len(self._surrogates),
                    "examples": sum(len(s.examples)
                                    for s in self._surrogates.values()),
                    "train_rounds": sum(s.train_rounds
                                        for s in self._surrogates.values()),
                },
            }
