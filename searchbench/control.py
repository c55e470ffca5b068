"""The readings that a cell's limits are set from, on the card.

    python3 -m searchbench.control --workload <cell> --seeds 1,2,3 \\
        --seconds 51 --plants none,tf32,no_evolution,half_scored

runs the cell once a seed and plant, in one process (set-up, a window
of ``--seconds`` at the cell's own load, the judgement), and prints a
JSON line a run: the compared numbers (``checks``) and ``correct``, with
the program as it is (``none``) or with a fault or a lower precision
planted in it (``PLANTS``), and the reading of the reference put in the
program's place with its distances one precision below the float32 the
search computes in (``controls``, ``tf32``). The benchmark's own runs do
not run this; the CPU tests plant the same faults.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from typing import Callable, Dict

from searchbench import run

CONTROLS = ("tf32",)

Patch = Callable[[object, str, object], None]


def _tf32(x):
    """``x`` (float32) rounded to TF32: 10 mantissa bits, to nearest."""
    import torch

    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


def tf32(patch: Patch) -> None:
    """B1 as a TF32 matrix product: the cross term of the distances from
    inputs rounded to TF32, summed in float32, in the scorer's place."""
    import torch

    from namazu_tpu_torch.ops import pair_distance as pd, schedule

    def segment(feats, rows, n):
        cross = _tf32(feats) @ _tf32(rows).T
        d = ((feats * feats).sum(-1, keepdim=True)
             + (rows * rows).sum(-1) - 2.0 * cross)
        if n is not None:
            live = (torch.arange(rows.shape[0], device=rows.device)
                    < torch.as_tensor(n, device=rows.device))
            d = torch.where(live, d, pd.MASK_BIG)
        return d.amin(-1).clamp_min(0.0)

    def pair(feats, archive, failures, archive_n=None, failure_n=None):
        return (segment(feats, archive, archive_n),
                segment(feats, failures, failure_n))

    patch(schedule, "min_sq_distance_pair", pair)


def no_evolution(patch: Patch) -> None:
    """The island step returns its population unchanged."""
    from namazu_tpu_torch.parallel import islands

    real = islands._step

    def step(state, *a, **k):
        new, fit = real(state, *a, **k)
        return new._replace(pop=state.pop), fit

    patch(islands, "_step", step)


def half_scored(patch: Patch) -> None:
    """The island step scores the first half of the population; the
    rest get the mean of those scores."""
    import torch

    from namazu_tpu_torch.parallel import islands

    real = islands.score_population_multi

    def score(delays, *a, **k):
        fitness, feats = real(delays, *a, **k)
        h = fitness.shape[0] // 2
        rest = fitness[:h].mean().expand(fitness.shape[0] - h)
        return torch.cat([fitness[:h], rest]), feats

    patch(islands, "score_population_multi", score)


def archive_unchanged(patch: Patch) -> None:
    """Ingest's step that records a run leaves the archive as it was."""
    from namazu_tpu_torch.models import search

    patch(search.SearchBase, "add_executed_trace",
          lambda self, *a, **k: None)


def half_references(patch: Patch) -> None:
    """Half of the reference runs left out, the fitness the mean over
    the rest."""
    from namazu_tpu_torch import sidecar

    real = sidecar.ingest_history
    patch(sidecar, "ingest_history", lambda *a, **k: real(*a, **k)[:2])


def answer_altered(patch: Patch) -> None:
    """The returned table's values in the wrong buckets (reversed), as
    an indexing slip where the answer is made would put them."""
    from namazu_tpu_torch import sidecar

    real = sidecar.SearchService._search_locked

    def altered(self, *a, **k):
        resp = real(self, *a, **k)
        if "delays" in resp:
            resp["delays"] = resp["delays"][::-1]
        return resp

    patch(sidecar.SearchService, "_search_locked", altered)


PLANTS: Dict[str, Callable[[Patch], None]] = {
    "none": lambda patch: None, "tf32": tf32, "no_evolution": no_evolution,
    "half_scored": half_scored, "archive_unchanged": archive_unchanged,
    "half_references": half_references, "answer_altered": answer_altered,
}


@contextlib.contextmanager
def planted(name: str):
    """The program with the plant ``name`` in it, restored on exit."""
    undo = []

    def patch(obj, attr, value):
        undo.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, value)

    try:
        PLANTS[name](patch)
        yield
    finally:
        for obj, attr, value in reversed(undo):
            setattr(obj, attr, value)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m searchbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--plants", default="none")
    args = ap.parse_args(argv)
    run.pin_caches(run.ROOT)
    cell = run.load_cell(args.workload, False)
    for plant in args.plants.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            t0 = time.perf_counter()
            with planted(plant):
                out = run.run_once(cell, seed, args.seconds, False, t0=t0,
                                   controls=CONTROLS)
            g = out["judged"]["gaps"]
            print(json.dumps({
                "workload": args.workload, "plant": plant, "seed": seed,
                "correct": out["result"]["correct"],
                "checks": {k: c["value"] for k, c in out["checks"].items()},
                "controls": {c: g[c] for c in CONTROLS},
                "judged": out["judged"]["judged"],
                "searched": out["judged"]["searched"],
                "metrics": {k: v["value"] for k, v in
                            out["result"]["metrics"].items()},
                "seconds": time.perf_counter() - t0}), flush=True)
    print(json.dumps({"card": run.card_line()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
